"""`utils/` of the port against the JAX package's (`utils/profiling.py`),
and `-profile_dir` (the counterpart of
tests/test_api.py::test_profile_dir_writes_trace):

- `SpmvRoofline` counts the JAX package's FLOP and bytes exactly; its
  bound takes the peaks of the named card (ops/roofline.py) and raises
  for a card whose peaks are not known;
- `-profile_dir` on `-device cpu` writes a Chrome trace of the run, one
  per rank under `-mesh_shape 2,1,1`, and the run's history is the one
  without the trace (every number equal); under `-fused 1` the trace
  holds the fused step's and the driver's spans (utils/spans.py).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.utils import profiling as jprof
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import run_topopt
from topopt_in_petsc_tpu_torch.ops.roofline import (
    H100_BYTES_PER_S,
    H100_F32_FLOP_PER_S,
)
from topopt_in_petsc_tpu_torch.utils import speed_of_light_spmv, trace_to
from topopt_in_petsc_tpu_torch.utils.profiling import TRACE_FILE, SpmvRoofline

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"


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


# the spans a -fused 1 run records (utils/spans.py); -restart 0 writes no
# restart, so `driver.restart` is not among them
FUSED_SPANS = {"fused.step", "fused.pre", "fused.pcg", "fused.head",
               "fused.mma_start", "fused.dip", "fused.post", "fused.flag",
               "driver.scalars", "driver.outputs"}


@pytest.mark.parametrize("flags, spans", [([], set()),
                                          (["-fused", "1"], FUSED_SPANS)],
                         ids=["split", "fused"])
def test_profile_dir_writes_a_trace_and_changes_no_number(flags, spans,
                                                          tmp_path):
    prof = tmp_path / "prof"
    traced = _run(tmp_path / "a", *flags, "-profile_dir", str(prof))
    _same_history(traced, _run(tmp_path / "b", *flags))
    names = {e.get("name") for e in _events(prof)}
    assert "aten::conv3d" in names  # the density filter's convolution
    assert {n for n in names if str(n).startswith(("fused.", "driver."))} \
        == spans


def test_profile_dir_on_a_mesh_writes_one_trace_per_rank(tmp_path):
    prof = tmp_path / "prof"
    mesh = ["-mesh_shape", "2,1,1"]
    traced = _run(tmp_path / "a", *mesh, "-profile_dir", str(prof))
    _same_history(traced, _run(tmp_path / "b", *mesh))
    assert sorted(os.listdir(prof)) == ["rank0", "rank1"]
    for r in (0, 1):
        names = {e.get("name") for e in _events(prof / f"rank{r}")}
        assert "aten::conv3d" in names
