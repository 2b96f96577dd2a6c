"""The mesh driver's other filter paths against the port's single-device
split `Driver`, float64, 17x9x9 nodes, 2 MG levels, mesh (2,2,2):

- the sensitivity filter (`-filter 0`), 6 iterations;
- Heaviside projection with beta continuation (`-projectionFilter 1
  -beta 1 -betaFinal 4`), 10 iterations: beta rises at iteration 10 and
  xPhys is projected again, with the line "Beta has been increased"
  printed once, by rank 0.  The projection run is also held to the JAX
  CLI's `-mesh_shape 2,2,2` history with these flags
  (`docs/jax_cpu_spmd_17x9x9_mesh222_projection_float64.npz`, command in
  PERF.md), and pins where the two part: at iteration 10 the JAX
  `SpmdDriver` logs the MND of the design before its re-projection with
  the new beta, where the reference (main.cc:92-102), the JAX split and
  fused drivers and the port compute it after (ROADMAP queue 3).

Bars: fx rtol 1e-6, gx, ch and mnd atol 1e-6, solver iterations within
1 (measured: 9e-7 in fx against the JAX `-mesh_shape 2,2,2` run over 12
iterations; the single-device and the mesh runs differ in the order of
their sums only).
"""

import os

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import run_topopt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["-device", "cpu", "-nx", "17", "-ny", "9", "-nz", "9", "-nlvls",
         "2", "-rmin", "0.16", "-dtype", "float64", "-output_cadence_vtu",
         "0", "-restart", "0"]


@pytest.mark.parametrize("flags,iters", [
    (["-filter", "0"], 6),
    (["-projectionFilter", "1", "-beta", "1", "-betaFinal", "4"], 10),
])
def test_mesh_filter_paths_match_single_device(flags, iters, tmp_path,
                                               capfd):
    args = [*FLAGS, *flags, "-maxItr", str(iters)]
    ref = run_topopt(TopOptConfig.from_args(
        [*args, "-workdir", str(tmp_path / "one")]))
    one = capfd.readouterr().out
    h = run_topopt(TopOptConfig.from_args(
        [*args, "-mesh_shape", "2,2,2", "-workdir", str(tmp_path / "mesh")]))
    mesh = capfd.readouterr().out
    assert len(h["fx"]) == len(ref["fx"]) == iters
    np.testing.assert_allclose(h["fx"], ref["fx"], rtol=1e-6)
    for k in ("gx", "ch", "mnd"):
        np.testing.assert_allclose(h[k], ref[k], atol=1e-6)
    assert np.max(np.abs(np.subtract(h["iters"], ref["iters"]))) <= 1
    beta = "Beta has been increased"
    assert mesh.count(beta) == one.count(beta)
    assert one.count(beta) == (1 if "-projectionFilter" in flags else 0)
    if "-projectionFilter" not in flags:
        return
    with np.load(os.path.join(
            REPO, "docs",
            "jax_cpu_spmd_17x9x9_mesh222_projection_float64.npz")) as r:
        jax = {k: r[k][:iters] for k in r.files}
    np.testing.assert_allclose(h["fx"], jax["fx"], rtol=1e-6)
    for k in ("gx", "ch"):
        np.testing.assert_allclose(h[k], jax[k], atol=1e-6)
    np.testing.assert_allclose(h["mnd"][:-1], jax["mnd"][:-1], atol=1e-6)
    assert abs(h["mnd"][-1] - jax["mnd"][-1]) > 0.05  # the JAX stale MND
