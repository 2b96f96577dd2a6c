"""Port vs JAX package: the reduced-precision V-cycle's solvers.

- the resident `BlockedElasticityMG` with `mg_dtype` bf16, "mixed" and
  `fine_post_smooth` 0 and 2, against the JAX package's (Pallas in
  interpret mode) at 9x5x5 nodes on 2 levels, the cases of the JAX
  package's own tests/test_blocked.py;
- the nodal `GeometricMultigrid(precond_dtype=bf16)` preconditioner
  against the JAX package's on the cantilever's 17x9x9 masked problem;
- a fault of the JAX package, pinned: its split state solve on the
  resident path under -mg_dtype bfloat16 converts the warm start through
  the bf16 V-cycle operator and fails; the port's converges.

Tolerances:
- solves reach relres < 1e-6 (their rtol); u within rtol 1e-2, atol
  1e-3 max|u| of the f32 solve (the JAX package's bar for these cases);
  outer iterations within 2 of the JAX package's: the two bf16 V-cycles
  round at other places.
- the bf16 preconditioner: |z_port - z_jax| <= 1e-2 max|z_jax|, several
  bf16 roundings on each side (the JAX side's coarse operator also runs
  in bf16, the port's K4 in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.grid import Grid as JaxGrid
from topopt_in_petsc_tpu.models.elasticity import (
    LinearElasticity as JaxElasticity,
)
from topopt_in_petsc_tpu.models.elasticity import build_cantilever_bc
from topopt_in_petsc_tpu.models.elements import hex8_stiffness
from topopt_in_petsc_tpu.solvers.blocked_mg import BlockedElasticityMG as JMG
from topopt_in_petsc_tpu.solvers.multigrid import (
    GeometricMultigrid as JaxGMG,
)
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.models.elasticity import LinearElasticity
from topopt_in_petsc_tpu_torch.ops.blocked_hex import HEX_OPERATOR_BF16
from topopt_in_petsc_tpu_torch.solvers.blocked_mg import BlockedElasticityMG
from topopt_in_petsc_tpu_torch.solvers.cg import (
    SEGMENT,
    pcg_active,
)
from topopt_in_petsc_tpu_torch.solvers.multigrid import GeometricMultigrid

torch.set_num_threads(1)

CPU = torch.device("cpu")
BF16 = torch.bfloat16
NN = (9, 5, 5)
RTOL = 1e-6


def _problem():
    grid = JaxGrid(nn=NN, lo=(0, 0, 0), hi=(2, 1, 1))
    grids = grid.hierarchy(2)
    KEs = [hex8_stiffness(*g.h, 0.3) for g in grids]
    x = np.random.default_rng(7).uniform(0.05, 1.0, size=grid.ne)
    E = (1e-9 + x**3 * (1 - 1e-9)).astype(np.float32)
    return grids, KEs, E


@pytest.fixture(scope="module")
def f32_solution():
    """The port's f32 solve, the reference of every bf16 solve."""
    grids, KEs, E = _problem()
    mg = BlockedElasticityMG(grids, KEs, device=CPU)
    b = mg.op32.cantilever_rhs()
    res = mg.solve(torch.from_numpy(E), b, torch.zeros_like(b), rtol=RTOL)
    assert float(res.relres) < RTOL
    return res.x


# name -> (port options, JAX options)
MODES = {
    "bf16": (dict(mg_dtype=BF16), dict(mg_dtype=jnp.bfloat16)),
    "mixed": (dict(mg_dtype="mixed"), dict(mg_dtype="mixed")),
    "bf16_post2": (dict(mg_dtype=BF16, fine_post_smooth=2),
                   dict(mg_dtype=jnp.bfloat16, fine_post_smooth=2)),
}


@pytest.mark.parametrize("mode", MODES)
def test_resident_bf16_solve_matches_jax(mode, f32_solution):
    grids, KEs, E = _problem()
    port_kw, jax_kw = MODES[mode]
    jmg = JMG(grids, KEs, interpret=True, **jax_kw)
    jop = jmg.op32
    _, RHS = build_cantilever_bc(grids[0])
    bj = jop.mask0(jop.to_blocked(jnp.asarray(RHS, jnp.float32)))
    ref = jmg.solve(jnp.asarray(E), bj, jnp.zeros_like(bj), rtol=RTOL,
                    maxiter=200)
    assert float(ref.relres) < RTOL

    mg = BlockedElasticityMG(grids, KEs, device=CPU, **port_kw)
    assert mg.op32.dtype == torch.float32
    assert [op.dtype for op in mg.ops] == [
        {jnp.float32: torch.float32, jnp.bfloat16: BF16}[d]
        for d in jmg.level_dtypes]
    assert (mg.op32 is mg.ops[0]) == (jmg.op32 is jmg.ops[0])
    assert mg.krylov_compress == BF16 and jmg.krylov_compress == jnp.bfloat16
    assert mg.fine_post_smooth == jmg.fine_post_smooth
    b = mg.op32.cantilever_rhs()
    got = mg.solve(torch.from_numpy(E), b, torch.zeros_like(b), rtol=RTOL)
    assert got.x.dtype == torch.float32
    assert float(got.relres) < RTOL
    assert abs(got.iters - int(ref.iters)) <= 2, (got.iters, int(ref.iters))
    u32 = f32_solution
    scale = float(u32.abs().max())
    torch.testing.assert_close(got.x, u32, rtol=1e-2, atol=1e-3 * scale)
    np.testing.assert_allclose(
        np.asarray(jop.from_blocked(ref.x)),
        mg.op32.from_blocked(u32).numpy(), rtol=1e-2, atol=1e-3 * scale)


def test_resident_bf16_levels_and_predicated_solve():
    """The level tensors are stored in their level's dtype; the predicated
    form (`start`, then `advance` in segments) gives `solve`'s x and
    iteration count bit for bit, its carried p in bf16."""
    grids, KEs, E = _problem()
    mg = BlockedElasticityMG(grids, KEs, device=CPU, mg_dtype=BF16,
                             fine_post_smooth=1)
    Et = torch.from_numpy(E)
    levels = mg.setup(Et)
    for lvl in levels:
        assert lvl["eb"].dtype == lvl["dinv"].dtype == BF16
        assert lvl["lmax"].dtype == torch.float32
    assert levels[0]["eb32"].dtype == torch.float32
    b = mg.op32.cantilever_rhs()
    rng = np.random.default_rng(3)
    x0 = mg.op32.mask0(torch.as_tensor(
        1e-3 * rng.normal(size=b.shape), dtype=torch.float32))
    before = HEX_OPERATOR_BF16.launches
    eager = mg.solve(Et, b, x0, rtol=RTOL)
    assert HEX_OPERATOR_BF16.launches == before  # plain versions on CPU
    levels, s = mg.start(Et, b, x0)
    assert s.p.dtype == BF16
    while bool(pcg_active(s, rtol=RTOL, maxiter=200)):
        s = mg.advance(levels, s, SEGMENT, rtol=RTOL)
    assert int(s.k) == eager.iters
    assert torch.equal(s.x, eager.x)


def test_fine_post_smooth_is_a_no_op_for_f32():
    grids, KEs, E = _problem()
    for kw in (dict(), dict(mg_dtype="mixed")):
        mg = BlockedElasticityMG(grids, KEs, device=CPU, fine_post_smooth=2,
                                 **kw)
        assert mg.op32 is mg.ops[0] and mg.fine_post_smooth == 0
    mg = BlockedElasticityMG(grids, KEs, device=CPU)
    assert mg.krylov_compress is None
    assert [op.dtype for op in mg.ops] == [torch.float32] * 2


# -- the nodal bf16 V-cycle ------------------------------------------------ #

NODAL_NN = (17, 9, 9)


def test_nodal_bf16_preconditioner_matches_jax():
    grid = JaxGrid(nn=NODAL_NN)
    grids = grid.hierarchy(2)
    KEs = [hex8_stiffness(*g.h, 0.3) for g in grids]
    N, _ = build_cantilever_bc(grid)
    masks = [N[:: 2**l, :: 2**l, :: 2**l] for l in range(2)]
    rng = np.random.default_rng(3)
    scale = (1e-9 + rng.uniform(0.0, 1.0, size=grid.ne) ** 3).astype(
        np.float32)
    r = (rng.normal(size=(*NODAL_NN, 3)) * masks[0]).astype(np.float32)

    ref_mg = JaxGMG(grids, KEs, masks, 3, precond_dtype=jnp.bfloat16)
    jm = ref_mg.mask_args()
    zj = np.asarray(ref_mg.preconditioner(ref_mg.setup(jnp.asarray(scale),
                                                       jm))(jnp.asarray(r)))

    mg = GeometricMultigrid(grids, KEs, masks, 3, device=CPU,
                            precond_dtype=BF16)
    levels = mg.setup(torch.from_numpy(scale))
    for lvl in levels:
        assert lvl["dinv"].dtype == BF16
        assert lvl["coef"].dtype == lvl["lmax"].dtype == torch.float32
    for predicated in (False, True):
        z = mg.preconditioner(levels, predicated=predicated)(
            torch.from_numpy(r))
        assert z.dtype == torch.float32
        np.testing.assert_allclose(z.numpy(), zj, rtol=0,
                                   atol=1e-2 * np.abs(zj).max())


# -- a fault of the reference, pinned ------------------------------------ #

def test_jax_resident_bf16_split_solve_fails_and_port_converges():
    """The JAX package's split state solve on the resident path with
    -mg_dtype bfloat16 builds its warm start with `ops[0].to_blocked`,
    which is the bf16 V-cycle operator's, and hands the bf16 x0 to its f32
    outer operator: `TypeError` (models/elasticity.py:273-274,
    ROADMAP queue 3).  The JAX package stays unchanged, so this pins the
    fault; the port converts through `op32` and converges."""
    kw = dict(nx=9, ny=5, nz=5, nlvls=2, operator_impl="blocked",
              mg_dtype="bfloat16")
    jcfg = JaxConfig(**kw)
    jcfg.validate()
    jph = JaxElasticity(jcfg)
    with pytest.raises(TypeError, match="same dtypes"):
        jph.solve_state(jnp.full(jph.grid.ne, 0.5, jnp.float32))

    cfg = TopOptConfig(**kw, device="cpu")
    cfg.validate()
    ph = LinearElasticity(cfg, device=CPU)
    x = torch.full(ph.grid.ne, 0.5)
    for u0 in (None, torch.zeros((*ph.grid.nn, 3))):
        res = ph.solve_state(x, u0)
        assert res.x.dtype == torch.float32
        assert float(res.relres) <= cfg.ksp_rtol and res.iters > 0
