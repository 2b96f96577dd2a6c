"""The 8-rank dry run of the three variants of the JAX package's
`__graft_entry__.py::dryrun_multichip` (its flags `-rmin 0.16` or 0.12
and `-ksp_maxit 30`), each held to the port's single-device `-fused 1`
run with the same flags, on the CPU, 2 iterations:

1. mesh (2,2,2), 33x17x17, 3 MG levels, density filter: on the default
   route (the resident solve) and on `-operator_impl pallas` (the nodal
   one);
2. mesh (4,2,1), 33x17x9, 2 levels, `-filter 2 -projectionFilter 1
   -beta 1`;
3. mesh (2,2,2), 17x17x17, 2 levels, `-operator_impl blocked`
   (`-ksp_chunk 2`, a no-op of the port, as the JAX variant passes it).

Bars (chip_smoke.py phase 21's): fx within 1e-4 at iteration 1 and 1e-3
at every iteration, solver iterations within 1, no stalled solve.

Each variant runs twice: with the default f64 sums, and as the JAX
variant is written, with f32 sums (`-precise_dots 0`).  With f32 sums the
`-filter 2` variant's first filter solve reaches f32's precision after
one iteration (below `-pde_rtol 1e-8`); its flexible step length is the
line search's there (solvers/cg.py), without which that solve grew to
NaN on the mesh and stalled the state solve on one device.
"""

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import run_topopt

torch.set_num_threads(1)

COMMON = ["-ksp_maxit", "30", "-maxItr", "2",
          "-output_cadence_vtu", "0", "-restart", "0", "-device", "cpu"]
VARIANTS = {
    "deep": ["-nx", "33", "-ny", "17", "-nz", "17", "-nlvls", "3",
             "-rmin", "0.16", "-mesh_shape", "2,2,2"],
    "deep-pallas": ["-nx", "33", "-ny", "17", "-nz", "17", "-nlvls", "3",
                    "-rmin", "0.16", "-operator_impl", "pallas",
                    "-mesh_shape", "2,2,2"],
    "filter2": ["-nx", "33", "-ny", "17", "-nz", "9", "-nlvls", "2",
                "-rmin", "0.16", "-filter", "2", "-projectionFilter", "1",
                "-beta", "1", "-mesh_shape", "4,2,1"],
    "blocked": ["-nx", "17", "-ny", "17", "-nz", "17", "-nlvls", "2",
                "-rmin", "0.12", "-operator_impl", "blocked",
                "-ksp_chunk", "2", "-mesh_shape", "2,2,2"],
}
# each variant as the JAX package writes it, with f32 sums
VARIANTS.update({f"{name}-f32-sums": ["-precise_dots", "0", *flags]
                 for name, flags in list(VARIANTS.items())})


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dryrun_variant_matches_single_device_fused(variant, tmp_path):
    flags = [*VARIANTS[variant], *COMMON]
    h = run_topopt(TopOptConfig.from_args(
        [*flags, "-workdir", str(tmp_path / "mesh")]))
    single = [*VARIANTS[variant][:-2], *COMMON]  # without -mesh_shape
    ref = run_topopt(TopOptConfig.from_args(
        [*single, "-fused", "1", "-workdir", str(tmp_path / "one")]))
    fx, fx_ref = np.asarray(h["fx"]), np.asarray(ref["fx"])
    assert len(fx) == len(fx_ref) == 2 and np.isfinite(fx).all()
    assert abs(fx[0] / fx_ref[0] - 1) <= 1e-4
    assert np.max(np.abs(fx / fx_ref - 1)) <= 1e-3
    assert np.max(np.abs(np.subtract(h["iters"], ref["iters"]))) <= 1
    assert not any(h["stalled"]) and not any(ref["stalled"])

