"""`-coarse_op galerkin_octant` and `-ksp_type fgmres` under `-mesh_shape`,
port against the JAX package: `python -m topopt_in_petsc_tpu_torch
-device cpu -nx 17 -ny 9 -nz 9 -nlvls 2 -rmin 0.16 -maxItr 4 -dtype
float64 -mesh_shape 2,2,2` plus the flags of each case, its 8 ranks
spawned in this process, against a JAX CLI history (`docs/`, commands in
PERF.md section 2).

- galerkin: the JAX `-mesh_shape 2,2,2` run (both packages on their
  `xla` route, octant-Galerkin coarse level);
- fgmres: the JAX **single-device** FGMRES run.  The JAX mesh runs
  flexible CG for `-ksp_type fgmres` (its `spmd_model.py:83-98,
  284-291`); the mesh changes where sums happen, not the math.  That JAX
  mesh history is pinned as what it is: the port's mesh `-ksp_type fcg`
  run (ROADMAP queue 3).

Bars.  With the V-cycle's coarse CG converged (`-coarse_rtol 1e-13
-coarse_maxit 200`) the port and the JAX package compute the same
numbers: fx rtol 1e-8, gx atol 1e-10, ch atol 1e-8, the same solver
iterations (measured: 8e-14 in fx for galerkin, 9e-15 for FGMRES).  At
the default coarse solve (`-coarse_rtol 1e-8 -coarse_maxit 30`, a
truncated CG) the order of the sums moves the preconditioner: the
port's and the JAX package's single-device FGMRES runs differ by 1.9e-6
in fx (galerkin by 1.5e-8) on one device already, and the mesh adds its
own order: fx rtol 1e-5 for FGMRES (measured 1.3e-6) and 1e-6 for
galerkin (2.2e-7), gx atol 1e-7, the same solver iterations.  The FCG
pin keeps the float64 mesh bars of tests/test_torch_spmd_cli.py (fx rtol
1e-8; measured 5.7e-9).
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
         "2", "-rmin", "0.16", "-maxItr", "4", "-dtype", "float64",
         "-mesh_shape", "2,2,2", "-output_cadence_vtu", "0", "-restart",
         "0"]
CONVERGED_COARSE = ["-coarse_rtol", "1e-13", "-coarse_maxit", "200"]
GALERKIN = ["-coarse_op", "galerkin_octant"]
FGMRES = ["-ksp_type", "fgmres"]
EXACT = dict(fx=1e-8, gx=1e-10, ch=1e-8)


def _history(name):
    with np.load(os.path.join(REPO, "docs", name)) as r:
        return {k: r[k] for k in r.files}


@pytest.mark.parametrize("flags,ref,bars", [
    (GALERKIN, "jax_cpu_spmd_17x9x9_mesh222_galerkin_float64.npz",
     dict(fx=1e-6, gx=1e-7, ch=1e-6)),
    (GALERKIN + CONVERGED_COARSE,
     "jax_cpu_spmd_17x9x9_mesh222_galerkin_float64_coarse13.npz", EXACT),
    (FGMRES, "jax_cpu_17x9x9_fgmres_float64.npz",
     dict(fx=1e-5, gx=1e-7, ch=1e-6)),
    (FGMRES + CONVERGED_COARSE, "jax_cpu_17x9x9_fgmres_float64_coarse13.npz",
     EXACT),
    # the JAX mesh's -ksp_type fgmres history is flexible CG's
    (["-ksp_type", "fcg"], "jax_cpu_spmd_17x9x9_mesh222_fgmres_float64.npz",
     EXACT),
], ids=["galerkin", "galerkin-converged-coarse", "fgmres",
        "fgmres-converged-coarse", "jax-mesh-fgmres-is-fcg"])
def test_mesh_option_matches_jax(flags, ref, bars, tmp_path):
    h = run_topopt(TopOptConfig.from_args(
        [*FLAGS, *flags, "-workdir", str(tmp_path)]))
    r = _history(ref)
    assert len(h["fx"]) == len(r["fx"]) == 4
    np.testing.assert_allclose(h["fx"], r["fx"], rtol=bars["fx"])
    np.testing.assert_allclose(h["gx"], r["gx"], atol=bars["gx"])
    np.testing.assert_allclose(h["ch"], r["ch"], atol=bars["ch"])
    np.testing.assert_array_equal(h["iters"], r["iters"])
    assert not np.any(h["stalled"])

