"""Profiling and speed-of-light analysis: the JAX package's
`utils/profiling.py`.

- `trace_to`: a `torch.profiler` window whose trace, in the Chrome trace
  format that Perfetto and `chrome://tracing` open, is written to
  `<logdir>/trace.json` when the window closes (also when its body
  raises).  It records the host's operators and, on a card, the card's
  kernels, copies and fills.  `-profile_dir` wraps the whole run in it
  (driver.py; every rank of `-mesh_shape` its own,
  parallel/spmd_driver.py).
- `SpmvRoofline`, `speed_of_light_spmv`: the JAX package's roofline of
  the matrix-free hex-operator apply, with its counts (a dense 24 x 24
  product per element, 55 values moved per element), against the peaks
  of the card it ran on (ops/roofline.py `card_peaks`).  Those counts
  are the reference's model, not the kernels' own work, which
  `ops/roofline.py::bound_ms` counts.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from topopt_in_petsc_tpu_torch.ops.roofline import card_peaks

TRACE_FILE = "trace.json"


@contextmanager
def trace_to(logdir: str, device):
    """Profile the body on the host and, when `device` is a card, on the
    card; write the trace to `<logdir>/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@dataclass
class SpmvRoofline:
    """Roofline estimate of the matrix-free hex-operator apply."""

    nelem: int
    dtype_bytes: int = 4

    @property
    def flops(self) -> float:
        # (nelem, 24) x (24, 24) matmul + quadratic scaling
        return 2.0 * 24 * 24 * self.nelem

    @property
    def bytes_moved(self) -> float:
        # gather reads u (24 values/elem effective), density read, result
        # write-back (24), nodal accumulate ~ 2x3 per node ~ elem
        vals = 24 + 1 + 24 + 6
        return vals * self.dtype_bytes * self.nelem

    def bound_seconds(self, card: str) -> float:
        """The larger of the bytes over the memory rate and the FLOP over
        the f32 peak of the card named `card` (raises for a card without
        known peaks)."""
        bytes_per_s, flop_per_s = card_peaks(card)
        return max(self.bytes_moved / bytes_per_s, self.flops / flop_per_s)


def speed_of_light_spmv(nelem: int, measured_s: float, card: str) -> dict:
    """The measured seconds of one apply on `nelem` elements beside the
    roofline bound on the card named `card`
    (`torch.cuda.get_device_name`)."""
    r = SpmvRoofline(nelem)
    bound = r.bound_seconds(card)
    return {
        "measured_s": measured_s,
        "bound_s": bound,
        "fraction_of_sol": bound / measured_s if measured_s > 0 else 0.0,
        "flops": r.flops,
        "bytes": r.bytes_moved,
    }
