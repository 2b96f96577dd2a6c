"""Port vs JAX package: PCG, the Chebyshev smoother and the resident MG-PCG
state solve (JAX: `BlockedElasticityMG(interpret=True)`).

Tolerances: the solves stop at rtol 1e-7 here, so both solutions agree to
1e-4 of max|u| (f32 fields, f64-accumulated dots), and the iteration
counts within one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.grid import Grid as JaxGrid
from topopt_in_petsc_tpu.models.elasticity import build_cantilever_bc
from topopt_in_petsc_tpu.models.elements import hex8_stiffness
from topopt_in_petsc_tpu.solvers.blocked_mg import BlockedElasticityMG as JMG
from topopt_in_petsc_tpu.solvers.cg import pcg as jpcg
from topopt_in_petsc_tpu.solvers.chebyshev import chebyshev_smooth as jcheb
from topopt_in_petsc_tpu_torch.solvers.blocked_mg import BlockedElasticityMG
from topopt_in_petsc_tpu_torch.solvers.cg import pcg
from topopt_in_petsc_tpu_torch.solvers.chebyshev import (
    chebyshev_smooth,
    gershgorin_lambda_max,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _spd(n=40, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(n, n))
    A = (Q @ Q.T + n * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    return A, b


@pytest.mark.parametrize("flexible", [True, False])
def test_pcg_matches(flexible):
    A, b = _spd()
    dinv = (1.0 / np.diag(A)).astype(np.float32)
    At, bt, dt = map(torch.from_numpy, (A, b, dinv))
    Aj, bj, dj = map(jnp.asarray, (A, b, dinv))
    got = pcg(lambda v: At @ v, bt, torch.zeros_like(bt),
              lambda r: dt * r, rtol=1e-6, flexible=flexible)
    ref = jpcg(lambda v: Aj @ v, bj, jnp.zeros_like(bj),
               lambda r: dj * r, rtol=1e-6, flexible=flexible)
    assert abs(got.iters - int(ref.iters)) <= 1
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                               rtol=1e-4, atol=1e-5)
    assert float(got.relres) <= 1e-6


@pytest.mark.parametrize("x_is_zero", [True, False])
def test_chebyshev_matches(x_is_zero):
    A, b = _spd(seed=1)
    dinv = (1.0 / np.diag(A)).astype(np.float32)
    x0 = np.zeros_like(b) if x_is_zero else \
        np.random.default_rng(2).normal(size=b.shape).astype(np.float32)
    R = np.abs(A).sum(axis=1)
    lmax_t = gershgorin_lambda_max(torch.from_numpy(R),
                                   torch.from_numpy(np.diag(A).copy()))
    assert float(lmax_t) == pytest.approx(float(np.max(R / np.diag(A))))
    got = chebyshev_smooth(
        lambda v: torch.from_numpy(A) @ v, torch.from_numpy(b),
        torch.from_numpy(x0), torch.from_numpy(dinv), lmax_t,
        degree=4, lower=0.06, upper=1.1, x_is_zero=x_is_zero)
    ref = jcheb(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b), jnp.asarray(x0),
        jnp.asarray(dinv), jnp.asarray(float(lmax_t), jnp.float32),
        degree=4, lower=0.06, upper=1.1, x_is_zero=x_is_zero)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("nn", [(9, 5, 5), (17, 9, 9)])
def test_resident_mgpcg_matches_jax(nn):
    grid = JaxGrid(nn=nn, lo=(0, 0, 0), hi=(2, 1, 1))
    grids = grid.hierarchy(2)
    KEs = [hex8_stiffness(*g.h, 0.3) for g in grids]
    rng = np.random.default_rng(1)
    x = rng.uniform(0.05, 1.0, size=grid.ne).astype(np.float32)
    E = (1e-9 + x.astype(np.float32) ** 3 * (1 - 1e-9)).astype(np.float32)
    _, RHS = build_cantilever_bc(grid)
    jmg = JMG(grids, KEs, interpret=True)
    op0 = jmg.ops[0]
    bj = op0.mask0(op0.to_blocked(jnp.asarray(RHS, jnp.float32)))
    ref = jmg.solve(jnp.asarray(E), bj, jnp.zeros_like(bj), rtol=1e-7,
                    maxiter=200)
    u_ref = np.asarray(op0.from_blocked(ref.x))

    tmg = BlockedElasticityMG(grids, KEs, device=CPU)
    top = tmg.ops[0]
    b = top.cantilever_rhs()
    got = tmg.solve(torch.from_numpy(E), b, torch.zeros_like(b), rtol=1e-7,
                    maxiter=200)
    u = top.from_blocked(got.x).numpy()
    assert float(got.relres) < 1e-7
    assert abs(got.iters - int(ref.iters)) <= 1
    np.testing.assert_allclose(u, u_ref, rtol=0,
                               atol=1e-4 * np.abs(u_ref).max())
