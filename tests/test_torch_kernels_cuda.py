"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked `cuda`; skipped where no CUDA device is visible.  Run
on a GPU machine with
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
(`--noconftest`: tests/conftest.py sets up jax, which a GPU machine
running only the port need not have).

Tolerance: rtol 2e-5, atol 1e-5 of max|ref| (the JAX package's bar for
its Pallas kernels, tests/test_blocked.py).  K1's bf16-storage build:
|got - ref| <= 2^-7 |ref| + 1e-5 max|ref|, both computing in f32 from the
same bf16 inputs and rounding once, so at most a rounding that falls the
other way differs (a bf16 ulp is 2^-7 relative at most).
"""

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.models.elements import (
    helmholtz_element_matrices,
    hex8_stiffness,
)
from topopt_in_petsc_tpu_torch.ops.blocked_hex import (
    HEX_OPERATOR,
    HEX_OPERATOR_BF16,
    hex_operator,
    hex_operator_grid,
    mask0,
)
from topopt_in_petsc_tpu_torch.ops.hex_operator import (
    apply_hex_operator,
    element_quadratic_form,
)
from topopt_in_petsc_tpu_torch.ops.nodal_hex import (
    HELMHOLTZ,
    NODAL_HEX,
    helmholtz,
    helmholtz_grid,
    nodal_hex,
    nodal_hex_grid,
)
from topopt_in_petsc_tpu_torch.ops.quadform import QUADFORM, quadform

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# small shapes, the edges of K1's 6 x 33 node tile in y-z (13x11x37 a
# multiple of it on neither axis, 9x9x33 and 5x17x65 whole tiles in z),
# and the 17^3 and 33^3 coarse levels of the 257^3 hierarchy
SHAPES = [(9, 7, 5), (13, 11, 7), (9, 5, 5), (17, 17, 17), (33, 17, 17),
          (9, 9, 33), (5, 17, 65), (13, 11, 37), (33, 33, 33)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _case(nn, dev):
    grid = Grid(nn=nn, lo=(0, 0, 0), hi=(2, 1, 1))
    KE = hex8_stiffness(*grid.h, 0.3)
    rng = np.random.default_rng(sum(nn))
    u = torch.as_tensor(rng.normal(size=(3, *nn)), dtype=torch.float32,
                        device=dev)
    E = torch.as_tensor(rng.uniform(1e-9, 1.0, size=grid.ne),
                        dtype=torch.float32, device=dev)
    return KE, u, E


def _close(got, ref):
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("mask_x0", [False, True])
@pytest.mark.parametrize("nn", SHAPES)
def test_k1_matches_plain(dev, nn, mask_x0):
    KE, u, E = _case(nn, dev)
    before = HEX_OPERATOR.launches
    got = hex_operator(u, E, KE, mask_x0)
    assert HEX_OPERATOR.launches == before + 1
    KEt = torch.as_tensor(KE, dtype=torch.float32, device=dev)
    ref = apply_hex_operator(u.permute(1, 2, 3, 0), E, KEt)
    ref = ref.permute(3, 0, 1, 2).contiguous()
    _close(got, mask0(ref) if mask_x0 else ref)


@pytest.mark.parametrize("nn", SHAPES)
def test_k2_matches_plain(dev, nn):
    KE, u, _ = _case(nn, dev)
    un = u.permute(1, 2, 3, 0).contiguous()
    before = QUADFORM.launches
    got = quadform(un, KE)
    assert QUADFORM.launches == before + 1
    KEt = torch.as_tensor(KE, dtype=torch.float32, device=dev)
    _close(got, element_quadratic_form(un, KEt))


def _plain_k1(u, E, KE, mask_x0):
    KEt = torch.as_tensor(KE, dtype=torch.float32, device=u.device)
    ref = apply_hex_operator(u.permute(1, 2, 3, 0), E, KEt)
    ref = ref.permute(3, 0, 1, 2).contiguous()
    return mask0(ref) if mask_x0 else ref


def test_ke_without_reflection_symmetry(dev):
    """A KE that is no brick's takes the 576-FMA products on its own."""
    KE, u, E = _case((13, 11, 37), dev)
    A = np.random.default_rng(3).normal(size=(24, 24))
    KEn = np.ascontiguousarray(KE + 1e-2 * np.abs(KE).max() * (A + A.T),
                               dtype=np.float32)
    _close(hex_operator(u, E, KEn, True), _plain_k1(u, E, KEn, True))
    un = u.permute(1, 2, 3, 0).contiguous()
    _close(quadform(un, KEn),
           element_quadratic_form(un, torch.as_tensor(KEn, device=dev)))


@pytest.mark.parametrize("nn", [(13, 11, 37), (65, 33, 33)])
def test_k1_k2_repeat_bitwise(dev, nn):
    """No atomics in the node or element sums: two launches give the same
    bits (the fused step's graph = eager check relies on it)."""
    KE, u, E = _case(nn, dev)
    for mask_x0 in (False, True):
        assert torch.equal(hex_operator(u, E, KE, mask_x0),
                           hex_operator(u, E, KE, mask_x0))
    un = u.permute(1, 2, 3, 0).contiguous()
    assert torch.equal(quadform(un, KE), quadform(un, KE))


# -- K1's bf16-storage build ----------------------------------------------- #

def _bf16_case(nn, dev):
    KE, u, E = _case(nn, dev)
    return KE, u.to(torch.bfloat16), E.to(torch.bfloat16)


def _close_bf16(got, ref):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    bad = (got - ref).abs() > 2.0**-7 * ref.abs() + 1e-5 * scale
    assert not bool(bad.any()), f"{int(bad.sum())} values off"


@pytest.mark.parametrize("mask_x0", [False, True])
@pytest.mark.parametrize("nn", SHAPES)
def test_k1_bf16_matches_plain(dev, nn, mask_x0):
    KE, u, E = _bf16_case(nn, dev)
    before = HEX_OPERATOR_BF16.launches, HEX_OPERATOR.launches
    got = hex_operator(u, E, KE, mask_x0)
    assert (HEX_OPERATOR_BF16.launches, HEX_OPERATOR.launches) == \
        (before[0] + 1, before[1])
    ref = _plain_k1(u.float(), E.float(), KE, mask_x0).to(torch.bfloat16)
    _close_bf16(got, ref)
    # the plain version on CPU tensors launches nothing
    cpu = hex_operator(u.cpu(), E.cpu(), KE, mask_x0)
    assert HEX_OPERATOR_BF16.launches == before[0] + 1
    _close_bf16(got.cpu(), cpu)


@pytest.mark.parametrize("nn", [(13, 11, 37), (65, 33, 33)])
def test_k1_bf16_repeat_bitwise(dev, nn):
    KE, u, E = _bf16_case(nn, dev)
    for mask_x0 in (False, True):
        assert torch.equal(hex_operator(u, E, KE, mask_x0),
                           hex_operator(u, E, KE, mask_x0))


def test_k1_bf16_without_reflection_symmetry(dev):
    KE, u, E = _bf16_case((13, 11, 37), dev)
    A = np.random.default_rng(5).normal(size=(24, 24))
    KEn = np.ascontiguousarray(KE + 1e-2 * np.abs(KE).max() * (A + A.T),
                               dtype=np.float32)
    _close_bf16(hex_operator(u, E, KEn, True),
                _plain_k1(u.float(), E.float(), KEn, True).to(torch.bfloat16))


def test_k1_grid_queries_tell_levels_apart(dev):
    levels = [(n,) * 3 for n in (257, 129, 65, 33, 17)]
    for dtype in (torch.float32, torch.bfloat16):
        grids = [hex_operator_grid(nn, dtype) for nn in levels]
        assert len(set(grids)) == len(levels)


# kernel, its wrapper, dof, element matrix of a grid
NODAL = {
    "K3": (HELMHOLTZ, helmholtz, 1,
           lambda g: helmholtz_element_matrices(*g.h, 0.05)[0]),
    "K4": (NODAL_HEX, nodal_hex, 3, lambda g: hex8_stiffness(*g.h, 0.3)),
}


def _nodal_case(name, nn, dev):
    _, _, dof, matrix = NODAL[name]
    grid = Grid(nn=nn, lo=(0, 0, 0), hi=(2, 1, 1))
    KE = np.ascontiguousarray(matrix(grid), dtype=np.float32)
    rng = np.random.default_rng(sum(nn) + dof)
    u = torch.as_tensor(rng.normal(size=(*nn, dof)), dtype=torch.float32,
                        device=dev)
    E = torch.as_tensor(rng.uniform(1e-3, 1.0, size=grid.ne),
                        dtype=torch.float32, device=dev)
    return KE, u, E


@pytest.mark.parametrize("name", NODAL)
@pytest.mark.parametrize("nn", SHAPES)
def test_nodal_kernels_match_plain(dev, nn, name):
    kernel, wrapper, _, _ = NODAL[name]
    KE, u, E = _nodal_case(name, nn, dev)
    before = kernel.launches
    got = wrapper(u, E, KE)
    assert kernel.launches == before + 1
    ref = apply_hex_operator(u, E, torch.as_tensor(KE, device=dev))
    _close(got, ref)
    # the plain version on CPU tensors launches nothing
    wrapper(u.cpu(), E.cpu(), KE)
    assert kernel.launches == before + 1


@pytest.mark.parametrize("name", NODAL)
@pytest.mark.parametrize("nn", [(13, 11, 37), (65, 33, 33)])
def test_nodal_kernels_repeat_bitwise(dev, nn, name):
    """K3 and K4 sum each node's corners in a fixed order: two launches
    give the same bits."""
    wrapper = NODAL[name][1]
    KE, u, E = _nodal_case(name, nn, dev)
    assert torch.equal(wrapper(u, E, KE), wrapper(u, E, KE))


@pytest.mark.parametrize("name", NODAL)
def test_nodal_matrix_without_reflection_symmetry(dev, name):
    """An element matrix that is no brick's takes the (8 dof)^2-FMA
    product on its own."""
    wrapper = NODAL[name][1]
    KE, u, E = _nodal_case(name, (13, 11, 37), dev)
    A = np.random.default_rng(4).normal(size=KE.shape)
    bent = np.ascontiguousarray(KE + 1e-2 * np.abs(KE).max() * (A + A.T),
                                dtype=np.float32)
    _close(wrapper(u, E, bent),
           apply_hex_operator(u, E, torch.as_tensor(bent, device=dev)))


def test_nodal_grid_queries_tell_levels_apart(dev):
    """A profile names K3's and K4's runs by level from their launch
    grids: every level of the 257^3 hierarchy has its own."""
    levels = [(n,) * 3 for n in (257, 129, 65, 33, 17)]
    for query in (helmholtz_grid, nodal_hex_grid):
        grids = [query(nn) for nn in levels]
        assert all(len(g) == 3 and min(g) >= 1 for g in grids)
        assert len(set(grids)) == len(levels)


def test_wrappers_refuse_bad_tensors(dev):
    KE, u, E = _case((9, 7, 5), dev)
    with pytest.raises(ValueError):
        hex_operator(u.double(), E, KE, True)
    with pytest.raises(ValueError):
        hex_operator(u, E[:-1], KE, True)
    with pytest.raises(ValueError):  # storage types differ
        hex_operator(u.to(torch.bfloat16), E, KE, True)
    with pytest.raises(ValueError):
        quadform(u.permute(1, 2, 3, 0), KE)  # not contiguous
    KE32 = np.ascontiguousarray(KE, dtype=np.float32)
    with pytest.raises(ValueError):
        nodal_hex(u.permute(1, 2, 3, 0), E, KE32)  # not contiguous
    with pytest.raises(ValueError):
        nodal_hex(u.permute(1, 2, 3, 0).contiguous(), E.double(), KE32)
    with pytest.raises(ValueError):
        helmholtz(u[:1].permute(1, 2, 3, 0).contiguous(), E, KE32)


def test_nodal_hex_widens_bf16(dev):
    """A bf16 u (the nodal bf16 V-cycle) goes through K4 widened to f32,
    with the f32 coefficient, and comes back rounded to bf16."""
    KE, u, E = _nodal_case("K4", (13, 11, 37), dev)
    ub = u.to(torch.bfloat16)
    before = NODAL_HEX.launches
    got = nodal_hex(ub, E, KE)
    assert NODAL_HEX.launches == before + 1
    ref = apply_hex_operator(ub.float(), E, torch.as_tensor(KE, device=dev))
    _close_bf16(got, ref.to(torch.bfloat16))


# -- the fused step's CUDA graphs ------------------------------------------ #

FUSED = dict(nx=17, ny=9, nz=9, nlvls=2, rmin=0.16, fused=True,
             output_cadence_vtu=False, restart=False, device="cuda")


def test_fused_step_graph_replay_equals_eager(dev):
    """Iterations 1-3 run eagerly and the steady variant is captured
    after iteration 3; iterations 4-5 replay it.  The same step kept
    eager gives the same state to 1e-6 relative."""
    from topopt_in_petsc_tpu_torch.config import TopOptConfig
    from topopt_in_petsc_tpu_torch.parallel.fused_step import (
        make_fused_step,
    )

    runs = []
    for graphs in (True, False):
        step, state = make_fused_step(TopOptConfig(**FUSED), graphs=graphs)
        for itr in range(1, 6):
            step(state, itr)
        torch.cuda.synchronize()
        assert (step.graphs is not None) == graphs
        runs.append(state)
    got, ref = runs
    assert int(got.solver_iters) == int(ref.solver_iters)
    for f in ("x", "xPhys", "L", "U", "fx", "gx", "ch", "mnd"):
        torch.testing.assert_close(getattr(got, f), getattr(ref, f),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("extra", [
    dict(mg_dtype="bfloat16"), dict(mg_dtype="mixed"),
    dict(mg_dtype="bfloat16", mg_fine_post=1),
    dict(mg_dtype="bfloat16", operator_impl="pallas"),
])
def test_fused_bf16_graph_replay_equals_eager(dev, extra):
    """The reduced-precision V-cycle's fused step: its bf16 carry and
    level tensors are captured like the f32 ones, and the replay gives the
    eager step's state."""
    from topopt_in_petsc_tpu_torch.config import TopOptConfig
    from topopt_in_petsc_tpu_torch.parallel.fused_step import (
        make_fused_step,
    )

    runs = []
    for graphs in (True, False):
        step, state = make_fused_step(TopOptConfig(**FUSED, **extra),
                                      graphs=graphs)
        before = HEX_OPERATOR_BF16.launches
        for itr in range(1, 6):
            step(state, itr)
        torch.cuda.synchronize()
        assert (step.graphs is not None) == graphs
        if extra.get("operator_impl") != "pallas":
            assert HEX_OPERATOR_BF16.launches > before
        runs.append(state)
    got, ref = runs
    assert int(got.solver_iters) == int(ref.solver_iters)
    for f in ("x", "xPhys", "L", "U", "fx", "gx", "ch", "mnd"):
        torch.testing.assert_close(getattr(got, f), getattr(ref, f),
                                   rtol=1e-6, atol=1e-7)


def test_fused_state_buffers_stay_put(dev, tmp_path):
    """The graphs read and write the state's tensors: no driver write
    rebinds one, across the iterations and the beta re-projection of
    iteration 10 (-projectionFilter 1)."""
    from topopt_in_petsc_tpu_torch.config import TopOptConfig
    from topopt_in_petsc_tpu_torch.fused_driver import FusedDriver

    cfg = TopOptConfig(**FUSED, maxItr=10, projectionFilter=True, beta=1.0,
                       eta=0.5, workdir=str(tmp_path))
    d = FusedDriver(cfg)
    ptrs = [t.data_ptr() for t in d.state]
    d.run()
    assert d.step.graphs is not None
    assert float(d.state.beta) == 2.0
    assert [t.data_ptr() for t in d.state] == ptrs
    with pytest.raises(ValueError, match="copy_"):
        d.step(d.state._replace(x=d.state.x.clone()), 11)
