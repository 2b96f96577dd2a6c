"""Port vs JAX package: the plain versions of kernels K1 and K2, the
resident operator's BC predicates and reductions, the MG setup stencils
and transfers.  The JAX side runs its Pallas kernels in interpret mode.

Tolerances: kernels rtol 2e-5, atol 1e-5 of max|ref| (the JAX package's
own bar for its Pallas kernels, tests/test_blocked.py); f64-accumulated
reductions rel 1e-6; stencils and transfers 1e-6 (f32, same sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.grid import Grid as JaxGrid
from topopt_in_petsc_tpu.models.elasticity import build_cantilever_bc
from topopt_in_petsc_tpu.models.elements import hex8_stiffness
from topopt_in_petsc_tpu.ops import hex_operator as jho
from topopt_in_petsc_tpu.ops.blocked_hex import BlockedHexOperator as JaxOp
from topopt_in_petsc_tpu.ops.pallas_hex import make_pallas_quadform
from topopt_in_petsc_tpu.solvers import multigrid as jmg
from topopt_in_petsc_tpu_torch.ops import hex_operator as tho
from topopt_in_petsc_tpu_torch.ops.blocked_hex import (
    HEX_OPERATOR,
    BlockedHexOperator,
)
from topopt_in_petsc_tpu_torch.ops.quadform import QUADFORM, quadform
from topopt_in_petsc_tpu_torch.solvers import multigrid as tmg

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _data(nn, seed):
    grid = JaxGrid(nn=nn, lo=(0, 0, 0), hi=(2, 1, 1))
    KE = hex8_stiffness(*grid.h, 0.3)
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(*nn, 3)).astype(np.float32)
    E = rng.uniform(1e-9, 1.0, size=grid.ne).astype(np.float32)
    return grid, KE, u, E


def _close(got, ref, rtol=2e-5, atol_rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=rtol, atol=atol_rel * np.abs(ref).max()
    )


@pytest.fixture(scope="module")
def case975():
    nn = (9, 7, 5)
    grid, KE, u, E = _data(nn, 3)
    jop = JaxOp(nn, KE, interpret=True)
    top = BlockedHexOperator(nn, KE, device=CPU)
    return nn, grid, KE, u, E, jop, top


def test_k1_plain_matches_jax_kernel(case975):
    nn, grid, KE, u, E, jop, top = case975
    ref = jop.from_blocked(jop.matvec(jop.to_blocked(jnp.asarray(u)),
                                      jop.prepare_coef(jnp.asarray(E))))
    vb = top.to_blocked(torch.from_numpy(u))
    eb = top.prepare_coef(torch.from_numpy(E))
    before = HEX_OPERATOR.launches
    got = top.from_blocked(top.matvec(vb, eb))
    _close(got.numpy(), ref)
    # masked form: the solver's operator, mask0(K v)
    ref_m = jop.from_blocked(jop.mask0(jop.matvec(
        jop.to_blocked(jnp.asarray(u)), jop.prepare_coef(jnp.asarray(E)))))
    _close(top.from_blocked(top.apply(vb, eb)).numpy(), ref_m)
    # CPU tensors take the plain version, which is no kernel launch
    assert HEX_OPERATOR.launches == before


def test_mask0_and_layout_roundtrip(case975):
    nn, grid, KE, u, E, jop, top = case975
    vb = top.to_blocked(torch.from_numpy(u))
    assert vb.shape == (3, *nn) and vb.is_contiguous()
    np.testing.assert_array_equal(top.from_blocked(vb).numpy(), u)
    ref = jop.from_blocked(jop.mask0(jop.to_blocked(jnp.asarray(u))))
    np.testing.assert_array_equal(
        top.from_blocked(top.mask0(vb)).numpy(), np.asarray(ref))


def test_dot_asum_match(case975):
    nn, grid, KE, u, E, jop, top = case975
    v = np.random.default_rng(7).normal(size=(*nn, 3)).astype(np.float32)
    ub, vb = jop.to_blocked(jnp.asarray(u)), jop.to_blocked(jnp.asarray(v))
    tu = top.to_blocked(torch.from_numpy(u))
    tv = top.to_blocked(torch.from_numpy(v))
    assert float(top.dot(tu, tv)) == pytest.approx(
        float(jop.dot(ub, vb)), rel=1e-6)
    assert float(top.asum(tu)) == pytest.approx(float(jop.asum(ub)),
                                                rel=1e-6)
    assert top.dot(tu, tv).dtype == torch.float64


@pytest.mark.parametrize("nn", [(9, 7, 5), (17, 9, 9)])
def test_cantilever_rhs_matches_bc(nn):
    top = BlockedHexOperator(nn, hex8_stiffness(0.25, 0.125, 0.25, 0.3),
                             device=CPU)
    N, RHS = build_cantilever_bc(JaxGrid(nn=nn))
    got = top.from_blocked(top.cantilever_rhs()).numpy()
    np.testing.assert_array_equal(got, RHS.astype(np.float32))
    jop = JaxOp(nn, hex8_stiffness(0.25, 0.125, 0.25, 0.3), interpret=True)
    np.testing.assert_array_equal(
        got, np.asarray(jop.from_blocked(jop.cantilever_rhs())))


@pytest.mark.parametrize("nn", [(9, 7, 5), (17, 9, 9), (12, 12, 12)])
def test_k2_plain_matches_jax_kernel(nn):
    grid, KE, u, E = _data(nn, 0)
    ref = make_pallas_quadform(nn, KE, interpret=True)(jnp.asarray(u))
    before = QUADFORM.launches
    got = quadform(torch.from_numpy(u), KE)
    assert got.shape == grid.ne
    _close(got.numpy(), ref)
    assert QUADFORM.launches == before


def test_setup_stencils_match():
    nn = (9, 7, 5)
    grid, KE, u, E = _data(nn, 1)
    KEj, KEt = jnp.asarray(KE, jnp.float32), torch.tensor(KE, dtype=torch.float32)
    Et = torch.from_numpy(E)
    for jf, tf in ((jho.hex_operator_diagonal, tho.hex_operator_diagonal),
                   (jho.hex_operator_absrowsum, tho.hex_operator_absrowsum)):
        _close(tf(Et, KEt, nn).numpy(), jf(jnp.asarray(E), KEj, nn),
               rtol=1e-6, atol_rel=1e-7)
    _close(tho.element_quadratic_form(torch.from_numpy(u), KEt).numpy(),
           jho.element_quadratic_form(jnp.asarray(u), KEj))


def test_transfers_match():
    rng = np.random.default_rng(5)
    fine = rng.normal(size=(9, 5, 5, 3)).astype(np.float32)
    coarse = rng.normal(size=(5, 3, 3, 3)).astype(np.float32)
    E = rng.uniform(0, 1, size=(8, 4, 4)).astype(np.float32)
    _close(tmg.restrict(torch.from_numpy(fine)).numpy(),
           jmg.restrict(jnp.asarray(fine)), rtol=1e-6, atol_rel=1e-7)
    _close(tmg.prolong(torch.from_numpy(coarse)).numpy(),
           jmg.prolong(jnp.asarray(coarse)), rtol=1e-6, atol_rel=1e-7)
    _close(tmg.coarsen_cell_field(torch.from_numpy(E)).numpy(),
           jmg.coarsen_cell_field(jnp.asarray(E)), rtol=1e-6, atol_rel=1e-7)
    # the resident layout transfers along axes 1-3, same values
    rb = tmg.restrict(torch.from_numpy(fine).permute(3, 0, 1, 2), (1, 2, 3))
    _close(rb.permute(1, 2, 3, 0).numpy(), jmg.restrict(jnp.asarray(fine)),
           rtol=1e-6, atol_rel=1e-7)
