"""The arithmetic of the hex-operator kernels K1, K3 and K4 and of K2
(csrc/hex_tile.cuh) and of K1-bf16's column body (csrc/hex_operator.cu),
emulated in torch on the CPU, against the JAX package's Pallas kernels in
interpret mode; the symmetry their element products rest on; the build
key over the kernels' headers; the kernels' device names as the smoke's
profiles find them; and the kernels' bounds (ops/roofline.py).

The emulation does what the kernels do, in their order:
  * the reflection product (the tile body's, for K1 and K4 with dof 3
    and K3 with dof 1, and K2's per-element form, for an element matrix
    with the brick's symmetry): v = D u_e by corner bits (D = 1 for a
    scalar field), an 8-point Walsh-Hadamard transform, the dof x dof
    blocks Q_k, the transform again, D again; for K2,
    q = sum_k V_k . Q_k V_k;
  * K1, K3 and K4: f_e = E_e * (u_e @ KE), then each node sums its
    corners in the fixed order 1, 2, 5, 6 (the previous element plane),
    0, 3, 4, 7; K1 zeroes the x = 0 plane when asked;
  * K1-bf16, on bf16 inputs widened to f32: each node plane's y-z half
    of the transform at every element column (corners m = oy | oz << 1),
    the x butterfly of the element's two planes, the blocks' entries in
    the pattern a brick's KE fills (the others, ~2e-8 of the largest in
    f32, dropped), E, the inverse x butterfly; per column and node
    plane, the carried ox = 1 forces of the element before plus this
    element's ox = 0 half, one inverse y-z half; each node sums its 4
    columns in the order m = 0, 1, 2, 3; rounded to bf16 once.

Tolerance: rtol 2e-5, atol 1e-5 of max|ref| (the JAX package's bar for
its Pallas kernels, tests/test_blocked.py).  K1-bf16: rtol 2^-7, atol
1e-5 of max|ref|: the emulation and the JAX kernel both compute in f32
from the same bf16 inputs and round once to bf16, their f32 sums in
another order, so a rounding may fall the other way (one bf16 ulp, 2^-7
relative at most).
"""

import functools
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.grid import Grid as JaxGrid
from topopt_in_petsc_tpu.models.elements import hex8_stiffness
from topopt_in_petsc_tpu.ops.blocked_hex import BlockedHexOperator as JaxOp
from topopt_in_petsc_tpu.ops.pallas_hex import (
    make_pallas_helmholtz_apply,
    make_pallas_hex_apply,
    make_pallas_quadform,
)
from topopt_in_petsc_tpu_torch.grid import CORNER_OFFSETS
from topopt_in_petsc_tpu_torch.models.elements import (
    helmholtz_element_matrices,
)
from topopt_in_petsc_tpu_torch.models.elements import (
    hex8_stiffness as torch_hex8_stiffness,
)
from topopt_in_petsc_tpu_torch.ops import cuda_build
from topopt_in_petsc_tpu_torch.ops.hex_operator import gather_element_dofs
from topopt_in_petsc_tpu_torch.ops.roofline import bound_ms, work

torch.set_num_threads(1)

# 17x9x9 and smaller fit one y-z tile; 13x11x37 is a multiple of no tile
# edge on any axis (6 x 33 node tiles of K1 and K4, x chunks); 9x14x37
# crosses K3's 12 x 33 tile on both axes
SHAPES = [(9, 7, 5), (13, 11, 7), (17, 9, 9), (13, 11, 37)]
NODAL_SHAPES = [(9, 7, 5), (13, 11, 37), (9, 14, 37)]
# the corner order of a node's sum: previous element plane, then this one
SUM_ORDER = (1, 2, 5, 6, 0, 3, 4, 7)
# corner a as bits ox | oy << 1 | oz << 2
BITS = [x | y << 1 | z << 2 for x, y, z in CORNER_OFFSETS]
CORNER = {c: a for a, c in enumerate(BITS)}


def _flip(c, dof=3):
    """D_c: -1 on the displacement components the reflection c flips; a
    scalar field (dof 1) is not flipped."""
    if dof == 1:
        return np.ones(1)
    return np.array([-1.0 if (c >> i) & 1 else 1.0 for i in range(3)])


def _block(KE, a, b, dof=3):
    """M(a, b), with f_a = sum_b M(a, b) u_b for f = u_e @ KE."""
    return KE[dof * b:dof * b + dof, dof * a:dof * a + dof].T


def reflection_blocks(KE):
    """(whether KE, (8 dof, 8 dof), has the brick's reflection symmetry to
    1e-6 of max|KE|, the blocks Q_k (8, dof, dof)):
    csrc/hex_tile.cuh::element_params."""
    KE = np.asarray(KE, dtype=np.float64)
    dof = KE.shape[0] // 8
    err = max(
        np.abs(_block(KE, a, b, dof) - _flip(BITS[a], dof)[:, None]
               * _block(KE, 0, CORNER[BITS[a] ^ BITS[b]], dof)
               * _flip(BITS[a], dof)[None, :]).max()
        for a in range(8) for b in range(8))
    P = [_block(KE, 0, CORNER[c], dof) * _flip(c, dof)[None, :]
         for c in range(8)]
    Q = np.array([sum((-1) ** bin(k & c).count("1") * P[c] for c in range(8))
                  / 8 for k in range(8)])
    return err <= 1e-6 * np.abs(KE).max(), Q


def _wht(x, n=8):
    """Unnormalised n-point Walsh-Hadamard transform over dim -2."""
    h = 1
    while h < n:
        idx = [c for c in range(n) if not c & h]
        a, b = x[..., idx, :], x[..., [c | h for c in idx], :]
        x = x.clone()
        x[..., idx, :], x[..., [c | h for c in idx], :] = a + b, a - b
        h *= 2
    return x


def _signs(dof, dtype):
    """D by corner: (8, dof), row a = D_bits(a)."""
    return torch.tensor(np.array([_flip(BITS[a], dof) for a in range(8)]),
                        dtype=dtype)


def _reflect_forward(ue):
    """V = WHT(D u_e), (..., 8 corner bits, dof)."""
    dof = ue.shape[-1] // 8
    u = ue.reshape(*ue.shape[:-1], 8, dof) * _signs(dof, ue.dtype)
    v = torch.empty_like(u)
    v[..., BITS, :] = u
    return _wht(v)


def _reflect_back(y):
    """f = D y by corner, (..., 8 dof) from (..., 8 corner bits, dof)."""
    dof = y.shape[-1]
    f = y[..., BITS, :] * _signs(dof, y.dtype)
    return f.reshape(*y.shape[:-2], 8 * dof)


def reflection_product(ue, KE):
    """u_e @ KE by the reflection blocks, in f32."""
    Q = torch.tensor(reflection_blocks(KE)[1], dtype=torch.float32)
    return _reflect_back(
        _wht(torch.einsum("kij,...kj->...ki", Q, _reflect_forward(ue))))


def emulate_nodal(u, E, KE):
    """The tile body on the nodal layout (nx, ny, nz, dof): K3 and K4."""
    dof = u.shape[-1]
    f = E[..., None] * reflection_product(gather_element_dofs(u), KE)
    ex, ey, ez = E.shape
    out = torch.zeros_like(u)
    for a in SUM_ORDER:
        x, y, z = CORNER_OFFSETS[a]
        out[x:x + ex, y:y + ey, z:z + ez] += f[..., dof * a:dof * a + dof]
    return out


def emulate_k1(vb, E, KE, mask_x0):
    """K1 on the resident layout (3, nx, ny, nz)."""
    out = emulate_nodal(vb.permute(1, 2, 3, 0), E, KE)
    if mask_x0:
        out[0] = 0.0
    return out.permute(3, 0, 1, 2)


def emulate_k2(u, KE):
    """K2 on the nodal layout (nx, ny, nz, 3), by the reflection blocks."""
    Q = torch.tensor(reflection_blocks(KE)[1], dtype=torch.float32)
    V = _reflect_forward(gather_element_dofs(u))
    return torch.einsum("...ki,kij,...kj->...", V, Q, V)


# K1-bf16's column body: D_yz by a column face's corner m = oy | oz << 1
# (component 1 flipped by oy, 2 by oz), and Dx (component 0 flipped)
YZ_SIGNS = torch.tensor([[1.0, -1.0 if m & 1 else 1.0,
                          -1.0 if m >> 1 else 1.0] for m in range(4)])
DX = torch.tensor([-1.0, 1.0, 1.0])
BF16_RTOL = 2.0**-7


def block_pattern():
    """{k: the entries of Q_k (bit 3 i + j) that K1-bf16's column body
    multiplies}, read from csrc/hex_operator.cu::block_pattern."""
    text = (cuda_build.CSRC / "hex_operator.cu").read_text()
    body = text[text.index("constexpr unsigned block_pattern(int k)"):]
    body = body[:body.index("}")]
    found = [int(v, 8) for v in re.findall(r"\b0([0-7]{3})u", body)]
    ks = [[0, 7], [1], [2], [3], [4], [5], [6]]
    assert len(found) == len(ks)
    return {k: v for group, v in zip(ks, found) for k in group}


def emulate_k1_bf16(vb, E, KE, mask_x0):
    """K1-bf16's column body on the resident layout: vb (3, nx, ny, nz)
    and E bf16, widened; the result rounded to bf16."""
    u, E = vb.float(), E.float()
    _, nx, ny, nz = u.shape
    pattern = block_pattern()
    keep = torch.tensor([[[(pattern[k] >> (3 * i + j)) & 1 for j in range(3)]
                          for i in range(3)] for k in range(8)])
    Q = torch.tensor(reflection_blocks(KE)[1], dtype=torch.float32) * keep
    # every node plane at every column's face corners, as WHT_yz(D_yz r):
    # (nx, ny - 1, nz - 1, 4, 3)
    r = torch.stack([u[:, :, m & 1:(m & 1) + ny - 1, m >> 1:(m >> 1) + nz - 1]
                     for m in range(4)], dim=-1)
    w = _wht(r.permute(1, 2, 3, 4, 0) * YZ_SIGNS, 4)
    # V = WHT(D u_e) by corner bits ox | m << 1: the x butterfly of node
    # plane x and Dx times plane x + 1
    a, b = w[:-1], w[1:] * DX
    v = torch.stack([a + b, a - b], dim=-2).flatten(-3, -2)
    y = torch.einsum("kij,...kj->...ki", Q, v) * E[..., None, None]
    f0 = y[..., 0::2, :] + y[..., 1::2, :]
    f1 = (y[..., 0::2, :] - y[..., 1::2, :]) * DX
    # per node plane: the element before's carried ox = 1 half plus this
    # element's ox = 0 half, then D_yz WHT_yz: each column's corner forces
    g = torch.zeros((nx, ny - 1, nz - 1, 4, 3))
    g[:-1] = f0
    g[1:] = f1 + g[1:]
    col = _wht(g, 4) * YZ_SIGNS
    out = torch.zeros((nx, ny, nz, 3))
    for m in range(4):
        oy, oz = m & 1, m >> 1
        out[:, oy:oy + ny - 1, oz:oz + nz - 1] += col[..., m, :]
    if mask_x0:
        out[0] = 0.0
    return out.permute(3, 0, 1, 2).to(torch.bfloat16)


def _data(nn, seed):
    grid = JaxGrid(nn=nn, lo=(0, 0, 0), hi=(2, 1, 1))
    KE = hex8_stiffness(*grid.h, 0.3)
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(*nn, 3)).astype(np.float32)
    E = rng.uniform(1e-9, 1.0, size=grid.ne).astype(np.float32)
    return KE, u, E


def _jax_k1(nn, KE, u, E, mask_x0):
    jop = JaxOp(nn, KE, interpret=True)
    out = jop.matvec(jop.to_blocked(jnp.asarray(u)),
                     jop.prepare_coef(jnp.asarray(E)))
    if mask_x0:
        out = jop.mask0(out)
    return np.moveaxis(np.asarray(jop.from_blocked(out)), -1, 0)


def _within_bar(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref) <= (
        1e-5 * np.abs(ref).max() + 2e-5 * np.abs(ref))


def _k1_inputs(KE, u, E):
    vb = torch.from_numpy(np.ascontiguousarray(np.moveaxis(u, -1, 0)))
    return vb, torch.from_numpy(E), np.asarray(KE, dtype=np.float32)


@pytest.mark.parametrize("mask_x0", [False, True])
@pytest.mark.parametrize("nn", SHAPES)
def test_k1_tile_arithmetic_matches_jax(nn, mask_x0):
    KE, u, E = _data(nn, sum(nn))
    got = emulate_k1(*_k1_inputs(KE, u, E), mask_x0)
    assert _within_bar(got.numpy(), _jax_k1(nn, KE, u, E, mask_x0)).all()


@functools.lru_cache(maxsize=None)
def _jax_k1_bf16(nn):
    """(KE, u, E, out, masked out) of the JAX package's K1 built with dtype
    bfloat16 (interpret mode) on _data's inputs, out (3, nx, ny, nz) f32:
    one JAX run serves both masks."""
    KE, u, E = _data(nn, sum(nn) + 2)
    jop = JaxOp(nn, KE, dof=3, dtype=jnp.bfloat16, interpret=True)
    out = jop.matvec(jop.refresh(jop.to_blocked(jnp.asarray(u))),
                     jop.prepare_coef(jnp.asarray(E)))
    return KE, u, E, *(
        np.moveaxis(np.asarray(jop.from_blocked(o).astype(jnp.float32)), -1,
                    0) for o in (out, jop.mask0(out)))


@pytest.mark.parametrize("mask_x0", [False, True])
@pytest.mark.parametrize("nn", SHAPES)
def test_k1_bf16_column_arithmetic_matches_jax(nn, mask_x0):
    """K1-bf16's column body, emulated on the bf16 inputs, against the JAX
    kernel built with dtype bfloat16."""
    KE, u, E, ref, masked = _jax_k1_bf16(nn)
    ref = masked if mask_x0 else ref
    vb = torch.from_numpy(np.ascontiguousarray(np.moveaxis(u, -1, 0)))
    got = emulate_k1_bf16(vb.to(torch.bfloat16),
                          torch.from_numpy(E).to(torch.bfloat16),
                          np.asarray(KE, dtype=np.float32), mask_x0)
    got = got.float().numpy()
    assert got.shape == ref.shape
    bar = BF16_RTOL * np.abs(ref) + 1e-5 * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= bar)
    if mask_x0:
        assert not got[:, 0].any()


@pytest.mark.parametrize("nn", SHAPES)
def test_k2_tile_arithmetic_matches_jax(nn):
    KE, u, _ = _data(nn, sum(nn) + 1)
    ref = make_pallas_quadform(nn, KE, interpret=True)(jnp.asarray(u))
    got = emulate_k2(torch.from_numpy(u), np.asarray(KE, dtype=np.float32))
    assert got.shape == ref.shape
    assert _within_bar(got.numpy(), ref).all()


@pytest.mark.parametrize("h", [(0.25, 0.125, 0.25), (1 / 256,) * 3,
                               (0.3, 0.7, 1.1)])
def test_reflection_blocks_reproduce_ke(h):
    """Every brick's KE has the symmetry, cubic or not, and its blocks give
    u_e @ KE to f64 rounding; a KE without the symmetry is told apart."""
    KE = torch_hex8_stiffness(*h, 0.3)
    sym, Q = reflection_blocks(KE)
    assert sym
    ue = torch.from_numpy(np.random.default_rng(1).normal(size=(5, 24)))
    V = _reflect_forward(ue)
    f = _reflect_back(
        _wht(torch.einsum("kij,...kj->...ki", torch.from_numpy(Q), V)))
    ref = ue @ torch.from_numpy(KE)
    assert float((f - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    q = torch.einsum("...ki,kij,...kj->...", V, torch.from_numpy(Q), V)
    torch.testing.assert_close(q, torch.sum(ref * ue, dim=-1), rtol=1e-12,
                               atol=0)
    bent = KE.copy()
    bent[0, 5] = bent[5, 0] = KE[0, 5] + 1e-3 * np.abs(KE).max()
    assert not reflection_blocks(bent)[0]


def _nodal_data(nn, dof, seed):
    grid = JaxGrid(nn=nn, lo=(0, 0, 0), hi=(2, 1, 1))
    if dof == 1:  # the default rmin 0.08, R = rmin / (2 sqrt 3)
        KE = helmholtz_element_matrices(*grid.h, 0.08 / (2 * 3**0.5))[0]
    else:
        KE = hex8_stiffness(*grid.h, 0.3)
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(*nn, dof)).astype(np.float32)
    E = rng.uniform(1e-3, 1.0, size=grid.ne).astype(np.float32)
    return np.asarray(KE, dtype=np.float32), u, E


@pytest.mark.parametrize("dof", [1, 3])
@pytest.mark.parametrize("nn", NODAL_SHAPES)
def test_nodal_tile_arithmetic_matches_jax(nn, dof):
    """K4 (dof 3) and K3 (dof 1) as the tile body computes them, against
    make_pallas_hex_apply and make_pallas_helmholtz_apply."""
    KE, u, E = _nodal_data(nn, dof, sum(nn) + dof)
    assert reflection_blocks(KE)[0]
    factory = make_pallas_helmholtz_apply if dof == 1 else make_pallas_hex_apply
    ref = factory(nn, KE, interpret=True)(jnp.asarray(u), jnp.asarray(E))
    got = emulate_nodal(torch.from_numpy(u), torch.from_numpy(E), KE)
    assert got.shape == ref.shape
    assert _within_bar(got.numpy(), ref).all()


@pytest.mark.parametrize("h", [(2 / 256, 1 / 256, 1 / 256), (0.1, 0.07, 0.05),
                               (1 / 64,) * 3])
def test_pde_hierarchy_has_scalar_reflection_symmetry(h):
    """Every KF of a 3-level PDE-filter hierarchy (h, 2h, 4h), cubic or
    not, is P(bits(a) XOR bits(b)); its modes lambda_k = 8 Q_k give
    u_e @ KF to f64 rounding and rebuild KF as H diag(lambda) H / 8; a KF
    without the symmetry is told apart."""
    H = np.array([[(-1) ** bin(k & c).count("1") for c in range(8)]
                  for k in range(8)], dtype=np.float64)
    perm = np.eye(8)[BITS]  # corner a -> bits(a)
    ue = torch.from_numpy(np.random.default_rng(2).normal(size=(5, 8)))
    for level in range(3):
        hl = [2**level * x for x in h]
        for rmin in (0.08, 0.02):
            KF = helmholtz_element_matrices(*hl, rmin / (2 * 3**0.5))[0]
            sym, Q = reflection_blocks(KF)
            assert sym and Q.shape == (8, 1, 1)
            lam = 8 * Q[:, 0, 0]
            rebuilt = perm.T @ H @ np.diag(lam) @ H @ perm / 8
            assert np.abs(rebuilt - KF).max() <= 1e-12 * np.abs(KF).max()
            f = _reflect_back(_wht(torch.from_numpy(Q[:, :, 0])
                                   * _reflect_forward(ue)))
            ref = ue @ torch.from_numpy(KF)
            assert float((f - ref).abs().max()) <= 1e-12 * float(
                ref.abs().max())
            # the constant mode carries the element's mass alone (the
            # Laplacian's rows sum to 0)
            assert lam[0] == pytest.approx(KF.sum() / 8, rel=1e-10)
    bent = KF.copy()
    bent[0, 3] = bent[3, 0] = KF[0, 3] + 1e-3 * np.abs(KF).max()
    assert not reflection_blocks(bent)[0]


# the 257^3 bounds of K1-K4: the compulsory bytes over 3.35 TB/s
BOUNDS_257 = {"K1": 0.141641521, "K2": 0.080837009, "K3": 0.060568838,
              "K4": 0.141641521}
LEVELS_257 = [(257,) * 3, (129,) * 3, (65,) * 3, (33,) * 3, (17,) * 3,
              (65, 33, 33), (9, 7, 5)]


@pytest.mark.parametrize("kernel", sorted(BOUNDS_257))
def test_bound_at_257_is_the_bytes(kernel):
    """At 257^3 every kernel's bound is its bytes: the element products
    the kernels run need fewer operations than the card does in that
    time (K1 would be operations-bound at 576 FMAs per element)."""
    ms, by = bound_ms(kernel, (257,) * 3)
    assert by == "bytes"
    assert ms == pytest.approx(BOUNDS_257[kernel], rel=1e-8)
    nbytes, flops = work(kernel, (257,) * 3)
    assert flops / 67e12 < nbytes / 3.35e12
    if kernel in ("K1", "K4"):
        assert 2 * 576 * 256**3 / 67e12 > nbytes / 3.35e12


@pytest.mark.parametrize("nn", LEVELS_257)
def test_bounds_are_the_bytes_at_every_level(nn):
    for kernel in BOUNDS_257:
        assert bound_ms(kernel, nn)[1] == "bytes"


def test_k1_operation_count_is_the_reflection_product():
    """K1's count is the emulated product's: per element two transforms
    of 72 adds, 24 multiplies and 48 FMAs in the blocks, 24 E scalings;
    21 adds per node for its 8 corner terms."""
    nn = (5, 4, 3)
    nnode, nelem = 60, 24
    transform = 3 * 4 * 2 * 3  # stages x pairs x (add, subtract) x 3
    blocks = 8 * 3 * (1 + 2 * 2)  # a multiply and two FMAs per row
    assert transform == 72 and blocks == 120
    assert work("K1", nn)[1] == (2 * transform + blocks + 24) * nelem \
        + 3 * 7 * nnode
    assert work("K2", nn)[1] == (transform + blocks + 2 * 24) * nelem


@pytest.mark.parametrize("h", [(2 / 256, 1 / 256, 1 / 256), (1 / 512,) * 3,
                               (0.3, 0.7, 1.1), (0.1, 0.01, 1.0)])
@pytest.mark.parametrize("nu", [0.0, 0.25, 0.3, 0.45])
def test_brick_blocks_fill_the_column_body_pattern(h, nu):
    """The entries of Q_k that K1-bf16 multiplies hold every entry that a
    brick's KE, rounded to f32, makes nonzero: every other entry is below
    1e-6 of the largest (the kernel's host check; ~2e-8 measured).  With
    nu > 0 the pattern is exactly the nonzero entries (nu = 0 also empties
    Q_0's off-diagonal)."""
    pattern = block_pattern()
    _, Q = reflection_blocks(np.asarray(torch_hex8_stiffness(*h, nu),
                                        dtype=np.float32))
    big = np.abs(Q) > 1e-6 * np.abs(Q).max()
    got = {k: sum(1 << (3 * i + j) for i in range(3) for j in range(3)
                  if big[k, i, j]) for k in range(8)}
    assert all(got[k] & ~pattern[k] == 0 for k in range(8))
    if nu > 0:
        assert got == pattern


def test_k1_bf16_operation_count_is_the_column_body():
    """K1-bf16's count is its column body's: per element one y-z half of
    the transform (the other half carried from the element before), the
    x butterfly, the blocks' nonzero entries for a brick (a multiply per
    row they fill, an FMA per further entry), E on those rows, the
    inverse x butterfly (less the pairs with an empty row), the carried
    forces added and one inverse y-z half; 9 adds per node for its 4
    columns."""
    nn = (5, 4, 3)
    nnode, nelem = 60, 24
    pattern = block_pattern()
    entries = sum(bin(v).count("1") for v in pattern.values())
    rows = [(k, i) for k in range(8) for i in range(3)
            if (pattern[k] >> (3 * i)) & 7]
    assert (entries, len(rows)) == (45, 21)
    empty = {(k, i) for k in range(8) for i in range(3)} - set(rows)
    half = 2 * 2 * 2 * 3  # stages x pairs x (add, subtract) x 3
    butterfly = 4 * 2 * 3  # pairs x (add, subtract) x 3
    blocks = len(rows) + 2 * (entries - len(rows))
    inverse = butterfly - 2 * len(empty)
    per_element = (half + butterfly + blocks + len(rows) + inverse + 12
                   + half)
    assert (half, butterfly, inverse, per_element) == (24, 24, 18, 192)
    assert work("K1-bf16", nn) == (2.0 * (6 * nnode + nelem),
                                   per_element * nelem + 3 * 3 * nnode)


def test_k3_operation_count_is_the_scalar_reflection_product():
    """K3's count is the dof-1 product's: per element two transforms of
    24 adds, 8 multiplies by the modes, 8 E scalings; 7 adds per node."""
    nn = (5, 4, 3)
    nnode, nelem = 60, 24
    transform = 3 * 4 * 2  # stages x pairs x (add, subtract)
    assert work("K3", nn)[1] == (2 * transform + 8 + 8) * nelem + 7 * nnode
    assert work("K3", nn)[0] == 4.0 * (2 * nnode + nelem)


def test_device_names_tell_the_kernels_apart():
    """A profile counts each kernel's device runs by a substring of its
    device function's name (chip_smoke._DEVICE_NAMES): every __global__
    of csrc/ is matched by exactly one entry, K1-bf16's by its own."""
    import chip_smoke

    text = "".join(p.read_text() for p in sorted(cuda_build.CSRC.glob("*.cu")))
    names = re.findall(
        r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", text)
    assert "hex_operator_bf16_kernel" in names
    owners = {n: [k for k, subs in chip_smoke._DEVICE_NAMES.items()
                  if any(s in n for s in subs)] for n in names}
    assert owners["hex_operator_bf16_kernel"] == ["K1-bf16"]
    assert owners["hex_operator_kernel"] == ["K1"]
    assert all(len(k) == 1 for k in owners.values()), owners


def test_build_key_covers_headers(tmp_path):
    """An edited header, source or an added header changes the key under
    which the library is built; an unchanged tree keeps it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh")) == ["hex_tile.cuh"]
    key = cuda_build.source_key(csrc)
    assert cuda_build.source_key(csrc) == key
    header = csrc / "hex_tile.cuh"
    text = header.read_bytes()
    header.write_bytes(text + b"\n")
    edited = cuda_build.source_key(csrc)
    assert edited != key
    header.write_bytes(text)
    assert cuda_build.source_key(csrc) == key
    (csrc / "extra.cuh").write_bytes(b"// another header\n")
    assert cuda_build.source_key(csrc) not in (key, edited)
    (csrc / "extra.cuh").unlink()
    src = csrc / cuda_build.SOURCES[0]
    src.write_bytes(src.read_bytes() + b"\n")
    assert cuda_build.source_key(csrc) != key
    # the package's own library is keyed the same way, and binds every
    # entry point at load
    lib = cuda_build._Library(csrc=csrc, build_dir=tmp_path / "build",
                              symbols=("hex_operator_f32",))
    assert lib.csrc == csrc and cuda_build.LIBRARY.csrc == cuda_build.CSRC
    assert lib.symbols == ("hex_operator_f32",)
    assert cuda_build.LIBRARY.symbols == tuple(cuda_build._SIGNATURES)
