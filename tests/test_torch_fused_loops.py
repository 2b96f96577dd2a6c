"""The predicated loops of the fused step against the loops they replace.

- PCG: `pcg_start` then segments of `pcg_trips` against the eager `pcg`
  on a seeded SPD problem, bit for bit in x, k and relres, for segment
  lengths 1, 3 and 8, on a solve that stops mid-segment and on one capped
  by maxiter; a converged carry takes no NaN from its discarded trips.
- The V-cycle of both multigrid classes with its coarse CG as predicated
  trips (the fused step's) against the eager coarse CG (the split
  driver's), bit for bit.
- MMA's dual interior point: the flattened predicated trips, in segments
  as the fused step runs them, against the JAX package's
  `MMA._update_impl` (its nested `while_loop`s) in f32 with f64 sums,
  x_new within 1e-6 (f32 fields, sums in another order), and against the
  split driver's nested f64 host loops (`MMA._solve_dip`), bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.opt.mma import MMA as JaxMMA
from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.models.elements import (
    helmholtz_element_matrices,
    hex8_stiffness,
)
from topopt_in_petsc_tpu_torch.opt.mma import MMA
from topopt_in_petsc_tpu_torch.solvers.blocked_mg import BlockedElasticityMG
from topopt_in_petsc_tpu_torch.solvers.cg import (
    SEGMENT,
    pcg,
    pcg_active,
    pcg_result,
    pcg_start,
    pcg_trips,
)
from topopt_in_petsc_tpu_torch.solvers.multigrid import GeometricMultigrid

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _spd(n=60, seed=0):
    """A seeded SPD system in f32 (condition ~1e3) with a Jacobi M."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (Q * np.logspace(0, 3, n)) @ Q.T + np.diag(rng.uniform(0, 10, n))
    A = torch.as_tensor(A, dtype=torch.float32)
    dinv = 1.0 / torch.diagonal(A)
    b = torch.as_tensor(rng.normal(size=n), dtype=torch.float32)
    x0 = torch.as_tensor(rng.normal(size=n) * 0.1, dtype=torch.float32)
    return (lambda v: A @ v), (lambda r: dinv * r), b, x0


# (rtol, maxiter): stops on the tolerance, or is capped by maxiter
CASES = {"converges": (1e-4, 200), "capped": (1e-12, 13)}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("flexible", [True, False])
def test_predicated_pcg_is_eager_pcg_bit_for_bit(case, n, flexible):
    rtol, maxiter = CASES[case]
    A, M, b, x0 = _spd()
    ref = pcg(A, b, x0, M, rtol=rtol, maxiter=maxiter, flexible=flexible)
    s = pcg_start(A, b, x0, M)
    segments = 0
    while bool(pcg_active(s, rtol=rtol, maxiter=maxiter)):
        s = pcg_trips(A, s, M, n, rtol=rtol, maxiter=maxiter,
                      flexible=flexible)
        segments += 1
    got = pcg_result(s)
    assert segments == math.ceil(ref.iters / n)
    assert int(got.iters) == ref.iters
    if case == "capped":
        assert ref.iters == maxiter
    assert torch.equal(got.x, ref.x)
    assert torch.equal(got.relres, ref.relres)


def test_discarded_trips_leak_no_nan():
    """b = 0: the solve is converged before its first trip, whose alpha
    is 0/0; the gated carry keeps x0 and stays finite."""
    A, M, b, _ = _spd()
    s = pcg_trips(A, pcg_start(A, torch.zeros_like(b), torch.zeros_like(b),
                               M), M, 4, rtol=1e-5, maxiter=50)
    assert int(s.k) == 0
    for t in s:
        assert torch.isfinite(t).all()
    assert not torch.any(s.x)


@pytest.mark.parametrize("mg", ["resident", "nodal_dof3", "nodal_dof1"])
def test_predicated_vcycle_is_eager_vcycle(mg):
    """17x9x9 nodes, 3 levels, a seeded SIMP scale and residual."""
    grids = Grid(nn=(17, 9, 9)).hierarchy(3)
    rng = np.random.default_rng(5)
    E = torch.as_tensor(1e-9 + rng.uniform(0, 1, grids[0].ne) ** 3,
                        dtype=torch.float32)
    if mg == "resident":
        KEs = [hex8_stiffness(*g.h, 0.3) for g in grids]
        solver = BlockedElasticityMG(grids, KEs, device=CPU)
        r = solver.ops[0].mask0(torch.as_tensor(
            rng.normal(size=(3, *grids[0].nn)), dtype=torch.float32))
    else:
        dof = 3 if mg == "nodal_dof3" else 1
        KEs = ([hex8_stiffness(*g.h, 0.3) for g in grids] if dof == 3 else
               [helmholtz_element_matrices(*g.h, 0.05)[0] for g in grids])
        solver = GeometricMultigrid(grids, KEs, None, dof, device=CPU)
        r = torch.as_tensor(rng.normal(size=(*grids[0].nn, dof)),
                            dtype=torch.float32)
    levels = solver.setup(E)
    eager = solver.vcycle(levels, r)
    assert torch.isfinite(eager).all()
    assert torch.equal(solver.vcycle(levels, r, predicated=True), eager)


def _mma_inputs(shape, m, seed):
    """Seeded MMA inputs as numpy f32: a design near 0.12, its history,
    asymptotes, sensitivities and movelimits."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    x = f(rng.uniform(0.05, 0.3, shape))
    d = {
        "x": x,
        "dfdx": f(-rng.uniform(0.1, 1.0, shape)),
        "gx": f(rng.uniform(-0.01, 0.01, m)),
        "dgdx": f(rng.uniform(0.5, 1.5, (m, *shape)) / np.prod(shape)),
        "xmin": f(np.maximum(x - 0.2, 0.0)),
        "xmax": f(np.minimum(x + 0.2, 1.0)),
        "L": f(x - rng.uniform(0.05, 0.5, shape)),
        "U": f(x + rng.uniform(0.05, 0.5, shape)),
        "xo1": f(x + rng.normal(0, 0.02, shape)),
        "xo2": f(x + rng.normal(0, 0.02, shape)),
    }
    return d


def _flat_dip(mma, sub):
    """The flattened dual interior point in segments of SEGMENT trips,
    one host read of the loop flag after each; returns x(lambda)."""
    d = mma.dip_start()
    while bool(mma.dip_active(d)):
        d = mma.dip_trips(d, sub, SEGMENT)
    return mma.dip_x(d, sub)


ORDER = ("x", "dfdx", "gx", "dgdx", "xmin", "xmax", "L", "U", "xo1", "xo2")


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("fresh", [True, False])
def test_flattened_dual_matches_jax_f32(m, fresh):
    shape = (8, 4, 4)
    n = int(np.prod(shape))
    d = _mma_inputs(shape, m, seed=10 * m + fresh)
    jm = JaxMMA(n, m, shape, dtype=jnp.float32, precise_dots=True)
    tm = MMA(n, m, shape, device=CPU, dtype=torch.float32,
             precise_dots=True)
    jx, jL, jU, *_ = jm._update_impl(
        *(jnp.asarray(d[k]) for k in ORDER), fresh_asymptotes=fresh)
    sub = tm._subproblem(*(torch.from_numpy(d[k]) for k in ORDER),
                         fresh_asymptotes=fresh)
    tx, tL, tU = _flat_dip(tm, sub), sub[0], sub[1]
    assert tx.dtype == torch.float32
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tL.numpy(), np.asarray(jL), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("fresh", [True, False])
def test_flattened_dual_is_nested_f64_loop(m, fresh):
    shape = (8, 4, 4)
    d = _mma_inputs(shape, m, seed=7 + m)
    tm = MMA(int(np.prod(shape)), m, shape, device=CPU)
    sub = tm._subproblem(*(torch.from_numpy(d[k]) for k in ORDER),
                         fresh_asymptotes=fresh)
    assert torch.equal(_flat_dip(tm, sub), tm._solve_dip(sub))
