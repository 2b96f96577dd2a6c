"""The plain reference against the program at 17x9x9 on the CPU: the
element matrices, the operator and the element energies, the load and
supports, both filters and one MMA update; then whole runs of each cell
at that size judged correct."""

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import elements, fem, filters, mma
from perfbench.tests.conftest import small

F64 = torch.float64
NN = (17, 9, 9)
NE = (16, 8, 8)
H = (2.0 / 16, 1.0 / 8, 1.0 / 8)


def _rand(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g, dtype=F64)


def test_element_matrices():
    from topopt_in_petsc_tpu_torch.models.elements import (
        helmholtz_element_matrices,
        hex8_stiffness,
    )

    h = (0.1, 0.07, 0.05)
    assert np.allclose(elements.elasticity_ke(h, 0.3),
                       hex8_stiffness(*h, 0.3), rtol=1e-13, atol=1e-16)
    assert np.allclose(elements.helmholtz_kf(h, 0.03),
                       helmholtz_element_matrices(*h, 0.03)[0],
                       rtol=1e-13, atol=1e-18)


def test_operator_energies_and_load():
    from topopt_in_petsc_tpu_torch.grid import Grid
    from topopt_in_petsc_tpu_torch.models.elasticity import (
        build_cantilever_bc,
    )
    from topopt_in_petsc_tpu_torch.ops.hex_operator import (
        apply_hex_operator,
        element_quadratic_form,
    )

    ke = elements.elasticity_ke(H, 0.3)
    u, E = _rand((*NN, 3), 1), _rand(NE, 2)
    ket = torch.as_tensor(ke)
    assert torch.allclose(fem.apply(u, E, ke),
                          apply_hex_operator(u, E, ket), rtol=1e-12)
    assert torch.allclose(fem.energies(u, ke),
                          element_quadratic_form(u, ket), rtol=1e-12)
    N, rhs = build_cantilever_bc(Grid(nn=NN))
    f, free = fem.cantilever(NN, "cpu")
    assert np.array_equal(f.numpy(), rhs) and np.array_equal(free.numpy(), N)


def _program_filter(kind):
    from topopt_in_petsc_tpu_torch.config import TopOptConfig
    from topopt_in_petsc_tpu_torch.grid import Grid
    from topopt_in_petsc_tpu_torch.opt.filters import DesignFilter

    cfg = TopOptConfig.from_args([
        "-nx", "17", "-ny", "9", "-nz", "9", "-nlvls", "2", "-rmin", "0.4",
        "-filter", str(kind), "-dtype", "float64", "-device", "cpu",
        "-pde_nlvls", "2", "-pde_rtol", "1e-13", "-pde_maxit", "500"])
    return DesignFilter(cfg, Grid.from_config(cfg), device="cpu",
                        pde_smoke=False)


@pytest.mark.parametrize("kind", [1, 2])
def test_filters(kind):
    prog = _program_filter(kind)
    ref = filters.make_filter(kind, NE, H, 0.4, "cpu")
    x, g = _rand(NE, 3), _rand(NE, 4) - 0.5
    xt, _ = prog.filter_project(x)
    assert torch.allclose(ref(x), xt, rtol=0, atol=1e-10)
    dg, _ = prog.gradients(x, xt, g, g[None])
    assert torch.allclose(ref.chain(g), dg, rtol=0, atol=1e-10)


def test_mma_update():
    from topopt_in_petsc_tpu_torch.opt.mma import MMA

    x = 0.1 + 0.8 * _rand(NE, 5)
    xo1 = (x + 0.05 * (_rand(NE, 6) - 0.5)).clamp(0, 1)
    xo2 = (xo1 + 0.05 * (_rand(NE, 7) - 0.5)).clamp(0, 1)
    dfdx = -_rand(NE, 8) - 0.01
    dgdx = torch.full((1, *NE), 1.0 / x.numel(), dtype=F64)
    gx = torch.tensor([float(x.mean()) - 0.3], dtype=F64)
    xmin, xmax = (x - 0.2).clamp(min=0), (x + 0.2).clamp(max=1)
    L, U = x - 0.3, x + 0.3
    prog = MMA(x.numel(), 1, NE, device="cpu")
    prog.state = prog.state._replace(L=L, U=U, xo1=xo1, xo2=xo2, k=3)
    want = prog.update(x, dfdx, gx, dgdx, xmin, xmax)
    got, gL, gU = mma.update(x, dfdx, gx, dgdx[0], xmin, xmax, L, U, xo1,
                             xo2)
    assert torch.allclose(got, want, rtol=0, atol=1e-7)
    assert torch.allclose(gL, prog.state.L) and \
        torch.allclose(gU, prog.state.U)


@pytest.mark.parametrize("cell", ["c257.fused", "c257.pde", "c257.bf16"])
def test_a_sound_run_is_correct(cell):
    spec = small(harness.cell_spec(cell))
    r = harness.run_cell(spec, 2 ** 31 + 21, 0.5, False, device="cpu")
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "compared"
