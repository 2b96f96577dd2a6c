"""The `-mesh_shape` CLI, port against the JAX package: `python -m
topopt_in_petsc_tpu_torch -device cpu -nx 17 -ny 9 -nz 9 -nlvls 2 -rmin
0.16 -maxItr 4 -mesh_shape 2,2,2`, run as a subprocess that spawns its 8
ranks, against the JAX CLI's `-mesh_shape 2,2,2` history with the same
flags.

- float64 (both packages on their `xla` route): the JAX run in this
  process on the 8 virtual CPU devices; fx rtol 1e-8, gx atol 1e-10, ch
  atol 1e-8, the same solver iterations;
- float32 on the default route (the port's resident solve on K1, the JAX
  `-operator_impl blocked`): against
  `docs/jax_cpu_spmd_17x9x9_mesh222_blocked.npz`, the JAX CLI's history
  in interpret mode (about a minute to run, its command in PERF.md); fx
  rtol 1e-3, solver iterations within 1; and the log: the JAX
  `SpmdDriver`'s lines printed once (by rank 0), the mesh line, one
  launch-count line per rank.

Also: each option of the single-device solvers (`-mg_dtype`,
`-mg_fine_post`, `-coarse_op`, `-ksp_type fgmres`) on mesh (2,1,1)
against the single-device `-fused 1` run, and without `-device cpu` and
with no card the run raises as the single-card CLI does.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.driver import run_topopt as jax_run_topopt
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import run_topopt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["-nx", "17", "-ny", "9", "-nz", "9", "-nlvls", "2", "-rmin",
         "0.16", "-maxItr", "4", "-mesh_shape", "2,2,2",
         "-output_cadence_vtu", "0"]

NUM = r"-?[0-9]+\.[0-9]+"
LOG_LINES = [
    re.compile(rf"^State solver:  iter: \d+, rerr\.: {NUM}e[-+]\d\d, "
               rf"time: {NUM}$"),
    re.compile(rf"^It\.: \d+, True fx: {NUM}, Scaled fx: {NUM}, "
               rf"gx\[0\]: {NUM}, ch\.: {NUM}, mnd\.: {NUM}, time: {NUM}$"),
]


def _port_cli(workdir, *flags):
    """(history, stdout lines) of the port's CLI run in a subprocess."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "topopt_in_petsc_tpu_torch", "-device",
         "cpu", *FLAGS, *flags, "-workdir", str(workdir)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    with np.load(os.path.join(workdir, "history.npz")) as h:
        return {k: h[k] for k in h.files}, out.stdout.splitlines()


def test_float64_history_matches_jax(tmp_path):
    h, _ = _port_cli(tmp_path / "port", "-dtype", "float64")
    jcfg = JaxConfig.from_args(
        [*FLAGS, "-dtype", "float64", "-workdir", str(tmp_path / "jax")])
    ref = jax_run_topopt(jcfg)
    assert len(h["fx"]) == len(ref["fx"]) == 4
    np.testing.assert_allclose(h["fx"], ref["fx"], rtol=1e-8)
    np.testing.assert_allclose(h["gx"], ref["gx"], atol=1e-10)
    np.testing.assert_allclose(h["ch"], ref["ch"], atol=1e-8)
    np.testing.assert_array_equal(h["iters"], ref["iters"])


def test_float32_history_and_log_match_jax(tmp_path):
    h, lines = _port_cli(tmp_path)
    with np.load(os.path.join(REPO, "docs",
                              "jax_cpu_spmd_17x9x9_mesh222_blocked.npz")) \
            as r:
        ref = {k: r[k] for k in r.files}
    np.testing.assert_allclose(h["fx"], ref["fx"], rtol=1e-3)
    assert np.max(np.abs(h["iters"] - ref["iters"])) <= 1
    assert not h["stalled"].any()
    banner = TopOptConfig.from_args(FLAGS).banner().splitlines()
    assert lines.count(banner[2]) == 1  # the banner, once
    assert lines.count(
        "# mesh 2,2,2: 8 ranks on the CPU over gloo") == 1
    for pattern in LOG_LINES:
        assert sum(bool(pattern.match(ln)) for ln in lines) == 4
    ranks = sorted(int(m.group(1)) for m in
                   (re.match(r"^# rank (\d+) launches \{", ln)
                    for ln in lines) if m)
    assert ranks == list(range(8))


MIXED_WARNING = "warning: -mg_dtype mixed needs the blocked solver"


@pytest.mark.parametrize("flags", [
    ["-mg_dtype", "bfloat16"],
    ["-mg_dtype", "mixed", "-mg_fine_post", "2"],
    ["-coarse_op", "galerkin_octant"],
    ["-ksp_type", "fgmres"],
    ["-ksp_type", "fgmres", "-operator_impl", "pallas"],
    ["-mg_dtype", "mixed", "-operator_impl", "pallas"],
], ids=["bf16", "mixed-fine-post", "galerkin", "fgmres", "fgmres-pallas",
        "mixed-pallas"])
def test_mesh_options_match_single_device(flags, tmp_path, capfd):
    """Each option of the multi-device engine on mesh (2,1,1), 3
    iterations, against the single-device `-fused 1` run with the same
    flags (the bars of chip_smoke.py phase 23): fx rtol 1e-4 at iteration
    1 and 1e-3 at every iteration, solver iterations within 1, never
    stalled; `mixed` on the nodal route warns once (rank 0), as one
    device does, and runs the f32 V-cycle."""
    args = ["-device", "cpu", *FLAGS[:-6], "-maxItr", "3", "-restart", "0",
            "-output_cadence_vtu", "0", *flags]
    ref = run_topopt(TopOptConfig.from_args(
        [*args, "-fused", "1", "-workdir", str(tmp_path / "one")]))
    one = capfd.readouterr().err
    h = run_topopt(TopOptConfig.from_args(
        [*args, "-mesh_shape", "2,1,1", "-workdir", str(tmp_path / "mesh")]))
    mesh = capfd.readouterr().err
    rel = np.abs(np.asarray(h["fx"]) / np.asarray(ref["fx"]) - 1)
    assert len(rel) == 3 and rel[0] <= 1e-4 and rel.max() <= 1e-3, rel
    assert np.max(np.abs(np.subtract(h["iters"], ref["iters"]))) <= 1
    assert not np.any(h["stalled"])
    nodal_mixed = "mixed" in flags and "pallas" in flags
    assert mesh.count(MIXED_WARNING) == one.count(MIXED_WARNING) == \
        int(nodal_mixed)


def test_mesh_that_does_not_divide_the_grid_raises():
    with pytest.raises(ValueError, match="not divisible"):
        TopOptConfig.from_args([*FLAGS[:-6], "-mesh_shape", "3,1,1"])


def test_no_card_raises_as_the_single_card_cli(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the run would use it")
    cfg = TopOptConfig.from_args([*FLAGS, "-workdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_topopt(cfg)
