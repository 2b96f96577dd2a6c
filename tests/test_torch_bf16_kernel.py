"""Port vs JAX package, the pieces of the reduced-precision V-cycle
(`-mg_dtype bfloat16|mixed`): the auto rules of the configuration, the
plain version of K1's bf16-storage build and PCG with a bf16 search
direction and kept ``A p``.

Tolerances:
- K1-bf16: |port - jax| <= 2^-7 |jax| + 1e-5 max|jax| elementwise.  Both
  compute in f32 from the same bf16 inputs and round once to bf16, so only
  a rounding that falls the other way (one bf16 ulp, 2^-7 relative at
  most) may differ; the f32 sums run in another order.
- PCG: the same iteration count within 1, x to rtol 1e-4 (atol 1e-5):
  both stop at rtol 1e-6 on a well-conditioned system.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.grid import Grid as JaxGrid
from topopt_in_petsc_tpu.models.elements import hex8_stiffness
from topopt_in_petsc_tpu.ops.blocked_hex import BlockedHexOperator as JaxOp
from topopt_in_petsc_tpu.solvers.cg import pcg as jpcg
from topopt_in_petsc_tpu_torch.config import MG_BF16_DOF, TopOptConfig
from topopt_in_petsc_tpu_torch.ops.blocked_hex import (
    HEX_OPERATOR_BF16,
    BlockedHexOperator,
)
from topopt_in_petsc_tpu_torch.ops.roofline import bound_ms, work
from topopt_in_petsc_tpu_torch.solvers.cg import (
    SEGMENT,
    pcg,
    pcg_active,
    pcg_start,
    pcg_trips,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
BF16 = torch.bfloat16


# -- the auto rules ---------------------------------------------------------- #

@pytest.mark.parametrize("mg_dtype", ["same", "bfloat16", "mixed"])
@pytest.mark.parametrize("sweeps", [2, 4])
@pytest.mark.parametrize("cheby_lower", [-1.0, 0.1])
def test_mg_rules_match_jax(mg_dtype, sweeps, cheby_lower):
    """Below both packages' auto thresholds the rules are the JAX
    package's: an explicit -mg_dtype wins, and the auto band's lower edge
    is 0.25 for a reduced-precision V-cycle of degree <= 2."""
    kw = dict(mg_dtype=mg_dtype, smooth_sweeps=sweeps,
              cheby_lower=cheby_lower)
    t, j = TopOptConfig(**kw), JaxConfig(**kw)
    t.validate()
    for ndof in (t.ndof, 3 * 257**3):
        assert t.resolve_mg_mode(ndof) == j.resolve_mg_mode(ndof)
        assert t.resolve_mg_bf16(ndof) == j.resolve_mg_bf16(ndof)
        assert t.resolve_cheby_lower(ndof) == j.resolve_cheby_lower(ndof)


def test_auto_bf16_threshold():
    """"-mg_dtype same" turns to bf16 from MG_BF16_DOF on, the threshold
    re-derived for an 80 GB card from the measured 513^3 peaks
    (config.py): there the f32 513^3 recipe still fits."""
    cfg = TopOptConfig()
    assert cfg.resolve_mg_mode(MG_BF16_DOF - 1) == "same"
    assert cfg.resolve_mg_mode(MG_BF16_DOF) == "bfloat16"
    assert cfg.resolve_mg_mode(3 * 513**3) == "same"
    cfg.smooth_sweeps = 2
    assert cfg.resolve_cheby_lower(3 * 513**3) == 0.06
    assert cfg.resolve_cheby_lower(MG_BF16_DOF) == 0.25


@pytest.mark.parametrize("flag", [["-mg_dtype", "bfloat16"],
                                  ["-mg_dtype", "mixed"],
                                  ["-mg_fine_post", "2"]])
def test_flags_of_the_bf16_vcycle_parse(flag):
    t, j = TopOptConfig.from_args(flag), JaxConfig.from_args(flag)
    assert (t.mg_dtype, t.mg_fine_post) == (j.mg_dtype, j.mg_fine_post)


# -- K1's bf16-storage build ---------------------------------------------- #

@pytest.mark.parametrize("nn", [(9, 7, 5), (13, 11, 7), (17, 9, 9)])
def test_k1_bf16_plain_matches_jax_kernel(nn):
    """The plain version of K1-bf16 against the JAX package's Pallas kernel
    built with dtype bfloat16 (interpret mode), through both packages'
    layout conversions."""
    grid = JaxGrid(nn=nn, lo=(0, 0, 0), hi=(2, 1, 1))
    KE = hex8_stiffness(*grid.h, 0.3)
    rng = np.random.default_rng(sum(nn))
    u = rng.normal(size=(*nn, 3)).astype(np.float32)
    E = rng.uniform(1e-3, 1.0, size=grid.ne).astype(np.float32)

    jop = JaxOp(nn, KE, dof=3, dtype=jnp.bfloat16, interpret=True)
    vb = jop.to_blocked(jnp.asarray(u))
    assert vb.dtype == jnp.bfloat16
    ref = jop.from_blocked(jop.matvec(jop.refresh(vb),
                                      jop.prepare_coef(jnp.asarray(E))))
    ref = np.asarray(ref.astype(jnp.float32))

    op = BlockedHexOperator(nn, KE, device=CPU, dtype=BF16)
    ub, eb = op.to_blocked(torch.from_numpy(u)), op.prepare_coef(
        torch.from_numpy(E))
    assert ub.dtype == eb.dtype == BF16
    before = HEX_OPERATOR_BF16.launches
    out = op.matvec(ub, eb)
    assert out.dtype == BF16 and HEX_OPERATOR_BF16.launches == before
    got = op.from_blocked(out).float().numpy()

    diff = np.abs(got - ref)
    bar = 2.0**-7 * np.abs(ref) + 1e-5 * np.abs(ref).max()
    assert np.all(diff <= bar), float(np.max(diff - bar))
    # at most a rounding that falls the other way: a small share differs
    assert np.count_nonzero(diff) <= 0.05 * diff.size
    # and the masked form zeroes the clamped wall
    masked = op.apply(ub, eb)
    assert torch.all(masked[:, 0] == 0)
    assert torch.equal(masked[:, 1:], out[:, 1:])


def test_k1_bf16_bound():
    """K1-bf16 moves half of K1's bytes, and its column body does 192
    FLOP per element and 9 per node (csrc/hex_operator.cu: one y-z
    half-transform per element, the other carried, and the blocks'
    nonzero entries), so its bound is the bytes at every level (at 257^3
    0.0708 ms against 0.0504 for its operations)."""
    for nn in ((513,) * 3, (257,) * 3, (65, 33, 33), (33,) * 3, (17,) * 3,
               (5, 3, 5)):
        nnode = nn[0] * nn[1] * nn[2]
        nelem = (nn[0] - 1) * (nn[1] - 1) * (nn[2] - 1)
        (b32, _), (b16, f16) = work("K1", nn), work("K1-bf16", nn)
        assert (b16, f16) == (b32 / 2, 192 * nelem + 9 * nnode)
        assert bound_ms("K1-bf16", nn)[1] == "bytes"
    ms, by = bound_ms("K1-bf16", (257,) * 3)
    assert by == "bytes" and ms == pytest.approx(0.070820761, rel=1e-8)


# -- PCG with a compressed carry ------------------------------------------- #

def _spd(n=40, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(n, n))
    A = (Q @ Q.T + n * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    return A, b, (1.0 / np.diag(A)).astype(np.float32)


@pytest.mark.parametrize("flexible", [True, False])
def test_compressed_pcg_matches_jax(flexible):
    A, b, dinv = _spd()
    At, bt, dt = map(torch.from_numpy, (A, b, dinv))
    Aj, bj, dj = map(jnp.asarray, (A, b, dinv))
    ref = jpcg(lambda v: Aj @ v, bj, jnp.zeros_like(bj), lambda r: dj * r,
               rtol=1e-6, flexible=flexible, flex_compress=jnp.bfloat16,
               p_compress=jnp.bfloat16)
    xr = np.asarray(ref.x)

    def A_(v):
        assert v.dtype == torch.float32  # p is widened before use
        return At @ v

    M = lambda r: dt * r  # noqa: E731
    got = pcg(A_, bt, torch.zeros_like(bt), M, rtol=1e-6,
              flexible=flexible, compress=BF16)
    assert abs(got.iters - int(ref.iters)) <= 1
    assert float(got.relres) <= 1e-6
    np.testing.assert_allclose(got.x.numpy(), xr, rtol=1e-4, atol=1e-5)

    # the predicated form: a bf16 carry, and the eager solve bit for bit
    s = pcg_start(A_, bt, torch.zeros_like(bt), M, compress=BF16)
    assert s.p.dtype == BF16 and s.x.dtype == s.r.dtype == torch.float32
    while bool(pcg_active(s, rtol=1e-6, maxiter=200)):
        s = pcg_trips(A_, s, M, SEGMENT, rtol=1e-6, maxiter=200,
                      flexible=flexible, compress=BF16)
        assert s.p.dtype == BF16
    assert int(s.k) == got.iters
    assert torch.equal(s.x, got.x)
    np.testing.assert_allclose(s.x.numpy(), xr, rtol=1e-4, atol=1e-5)
