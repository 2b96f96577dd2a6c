"""Port vs JAX package: the nodal operators of kernels K3 (dof 1,
Helmholtz) and K4 (dof 3, elasticity).  On the CPU the port's wrappers
run their plain version; the JAX side runs its Pallas kernels in
interpret mode (`make_pallas_helmholtz_apply`, `make_pallas_hex_apply`).

Tolerance: rtol 2e-5, atol 1e-5 of max|ref| (the JAX package's bar for
its Pallas kernels, tests/test_blocked.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.ops.pallas_hex import (
    make_pallas_helmholtz_apply,
    make_pallas_hex_apply,
)
from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.models.elements import (
    helmholtz_element_matrices,
    hex8_stiffness,
)
from topopt_in_petsc_tpu_torch.ops.nodal_hex import (
    HELMHOLTZ,
    NODAL_HEX,
    make_helmholtz_apply,
    make_nodal_hex_apply,
)

torch.set_num_threads(1)

SHAPES = [(9, 7, 5), (13, 11, 7)]
# dof -> (the port's factory, the JAX factory, the element matrix)
OPERATORS = {
    1: (make_helmholtz_apply, make_pallas_helmholtz_apply,
        lambda g: helmholtz_element_matrices(*g.h, 0.05)[0]),
    3: (make_nodal_hex_apply, make_pallas_hex_apply,
        lambda g: hex8_stiffness(*g.h, 0.3)),
}


def _case(nn, dof):
    grid = Grid(nn=nn, lo=(0, 0, 0), hi=(2, 1, 1))
    rng = np.random.default_rng(sum(nn) + dof)
    u = rng.normal(size=(*nn, dof)).astype(np.float32)
    E = rng.uniform(1e-3, 1.0, size=grid.ne).astype(np.float32)
    return grid, OPERATORS[dof][2](grid), u, E


def _close(got, ref):
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("dof", [1, 3])
@pytest.mark.parametrize("nn", SHAPES)
def test_nodal_operator_matches_pallas(nn, dof):
    grid, KE, u, E = _case(nn, dof)
    port, jax_factory, _ = OPERATORS[dof]
    launches = (HELMHOLTZ.launches, NODAL_HEX.launches)
    got = port(grid.nn, KE)(torch.from_numpy(u), torch.from_numpy(E))
    ref = jax_factory(grid.nn, KE, interpret=True)(
        jnp.asarray(u), jnp.asarray(E)
    )
    assert got.shape == (*nn, dof) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(ref))
    # CPU tensors run the plain version: no kernel launch is counted
    assert (HELMHOLTZ.launches, NODAL_HEX.launches) == launches


@pytest.mark.parametrize("dof", [1, 3])
def test_prepared_coef_matches_apply(dof):
    grid, KE, u, E = _case((13, 11, 7), dof)
    ap = OPERATORS[dof][0](grid.nn, KE)
    ut = torch.from_numpy(u)
    # a strided f64 view: prepare_coef makes it the kernel's layout
    E64 = torch.from_numpy(E.T.copy()).double().permute(2, 1, 0)
    assert not E64.is_contiguous()
    eb = ap.prepare_coef(E64)
    assert eb.dtype == torch.float32 and eb.is_contiguous()
    torch.testing.assert_close(ap.apply_prepared(ut, eb),
                               ap(ut, torch.from_numpy(E)), rtol=0, atol=0)


def test_operators_refuse_what_does_not_fit():
    grid = Grid(nn=(9, 7, 5))
    KE = hex8_stiffness(*grid.h, 0.3)
    u1 = torch.zeros((9, 7, 5, 1))
    u3 = torch.zeros((9, 7, 5, 3))
    E = torch.ones(grid.ne)
    with pytest.raises(ValueError):  # element matrix of another dof
        make_helmholtz_apply(grid.nn, KE)(u1, E)
    with pytest.raises(ValueError):
        make_nodal_hex_apply(grid.nn, np.eye(8))(u3, E)
    with pytest.raises(ValueError):  # field of another grid level
        make_nodal_hex_apply((9, 7, 7), KE)(u3, E)
