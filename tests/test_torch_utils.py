"""`utils/` of the port against the JAX package's (`utils/timers.py`,
`utils/profiling.py`), and `-profile_dir` (the counterpart of
tests/test_api.py::test_profile_dir_writes_trace):

- `Timer` and `timed` print the JAX package's report lines, character for
  character, on the same clock readings;
- `SpmvRoofline` counts the JAX package's FLOP and bytes exactly; its
  bound takes the peaks of the named card (ops/roofline.py) and raises
  for a card whose peaks are not known;
- `-profile_dir` on `-device cpu` writes a Chrome trace of the run, one
  per rank under `-mesh_shape 2,1,1`, and the run's history is the one
  without the trace (every number equal).
"""

import contextlib
import io
import itertools
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.utils import profiling as jprof
from topopt_in_petsc_tpu.utils import timers as jtimers
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import run_topopt
from topopt_in_petsc_tpu_torch.ops.roofline import (
    H100_BYTES_PER_S,
    H100_F32_FLOP_PER_S,
)
from topopt_in_petsc_tpu_torch.utils import (
    Timer,
    speed_of_light_spmv,
    timed,
    trace_to,
)
from topopt_in_petsc_tpu_torch.utils.profiling import TRACE_FILE, SpmvRoofline

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"


def _ticks(monkeypatch):
    """A clock that reads 0, 0.0123, 0.0246, ... seconds."""
    clock = (0.0123 * i for i in itertools.count())
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))


def _timer_report(timer_cls, sync):
    t = timer_cls()
    for name in ("solve", "filter", "solve"):
        with t.section(name, sync=sync):
            pass
    with t.section("mma"):
        pass
    return t.report()


def test_timer_report_matches_jax(monkeypatch):
    _ticks(monkeypatch)
    ours = _timer_report(Timer, torch.ones(3))
    _ticks(monkeypatch)
    theirs = _timer_report(jtimers.Timer, jnp.ones(3))
    assert ours == theirs
    assert ours.splitlines()[2] == \
        "solve: total 0.025 s, calls 2, avg 12.30 ms"


def test_timed_line_matches_jax(monkeypatch):
    lines = []
    for mod, value in ((jtimers, jnp.ones(2)), (None, torch.ones(2))):
        _ticks(monkeypatch)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            with (mod.timed if mod else timed)("state solve", result=value):
                pass
        lines.append(buf.getvalue())
    assert lines[0] == lines[1] == "state solve: 0.0123 s\n"


@pytest.mark.parametrize("nelem", [1, 8 * 4 * 4, 256**3])
def test_spmv_roofline_counts_match_jax(nelem):
    ours, theirs = SpmvRoofline(nelem), jprof.SpmvRoofline(nelem)
    assert ours.flops == theirs.flops == 2.0 * 24 * 24 * nelem
    assert ours.bytes_moved == theirs.bytes_moved == 55 * 4 * nelem
    bound = max(ours.bytes_moved / H100_BYTES_PER_S,
                ours.flops / H100_F32_FLOP_PER_S)
    assert ours.bound_seconds(H100) == bound
    sol = speed_of_light_spmv(nelem, 2 * bound, H100)
    assert sol == {"measured_s": 2 * bound, "bound_s": bound,
                   "fraction_of_sol": 0.5, "flops": theirs.flops,
                   "bytes": theirs.bytes_moved}


@pytest.mark.parametrize("card", ["TPU v5 lite", "cpu",
                                  "NVIDIA A100-SXM4-80GB"])
def test_speed_of_light_raises_for_an_unknown_card(card):
    with pytest.raises(ValueError, match="no peaks known"):
        speed_of_light_spmv(1000, 1e-3, card)


def _events(logdir):
    with open(os.path.join(logdir, TRACE_FILE)) as f:
        return json.load(f)["traceEvents"]


def test_trace_to_writes_when_the_body_raises(tmp_path):
    with pytest.raises(RuntimeError, match="body"):
        with trace_to(str(tmp_path), "cpu"):
            torch.ones(4).sum()
            raise RuntimeError("body")
    assert any(e.get("name") == "aten::sum" for e in _events(tmp_path))


RUN = ["-device", "cpu", "-nx", "17", "-ny", "9", "-nz", "9", "-nlvls", "2",
       "-rmin", "0.16", "-maxItr", "2", "-output_cadence_vtu", "0",
       "-restart", "0"]


def _run(tmp, *flags):
    with contextlib.redirect_stdout(io.StringIO()):
        return run_topopt(TopOptConfig.from_args(
            [*RUN, *flags, "-workdir", str(tmp)]))


def _same_history(a, b):
    for k in ("fx", "gx", "ch", "mnd", "iters", "stalled"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("flags", [[], ["-fused", "1"]],
                         ids=["split", "fused"])
def test_profile_dir_writes_a_trace_and_changes_no_number(flags, tmp_path):
    prof = tmp_path / "prof"
    traced = _run(tmp_path / "a", *flags, "-profile_dir", str(prof))
    _same_history(traced, _run(tmp_path / "b", *flags))
    names = {e.get("name") for e in _events(prof)}
    assert "aten::conv3d" in names  # the density filter's convolution


def test_profile_dir_on_a_mesh_writes_one_trace_per_rank(tmp_path):
    prof = tmp_path / "prof"
    mesh = ["-mesh_shape", "2,1,1"]
    traced = _run(tmp_path / "a", *mesh, "-profile_dir", str(prof))
    _same_history(traced, _run(tmp_path / "b", *mesh))
    assert sorted(os.listdir(prof)) == ["rank0", "rank1"]
    for r in (0, 1):
        names = {e.get("name") for e in _events(prof / f"rank{r}")}
        assert "aten::conv3d" in names
