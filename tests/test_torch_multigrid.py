"""Port vs JAX package: the nodal `GeometricMultigrid` (solvers/
multigrid.py) on 17x9x9 nodes, for the two ways the port uses it: dof 3
with the cantilever's Dirichlet masks on 2 levels (the nodal elasticity
solve) and dof 1 without masks on 3 levels (the Helmholtz PDE filter).
The JAX side runs its plain XLA operators, the port its kernels' plain
versions.

Tolerance: rtol 1e-5 (f32 fields; the V-cycle's coarse CG stops at 1e-8),
with an absolute floor of 1e-6 of max|ref| for entries near zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.grid import Grid as JaxGrid
from topopt_in_petsc_tpu.models.elasticity import build_cantilever_bc
from topopt_in_petsc_tpu.models.elements import (
    helmholtz_element_matrices,
    hex8_stiffness,
)
from topopt_in_petsc_tpu.solvers.multigrid import GeometricMultigrid as JMG
from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.solvers.multigrid import GeometricMultigrid

torch.set_num_threads(1)

CPU = torch.device("cpu")
NN = (17, 9, 9)


def _problem(dof):
    """(grids, KEs, masks, scale, residual) of one case, from a seed."""
    grids = Grid(nn=NN).hierarchy(2 if dof == 3 else 3)
    rng = np.random.default_rng(dof)
    if dof == 3:
        KEs = [hex8_stiffness(*g.h, 0.3) for g in grids]
        N, _ = build_cantilever_bc(JaxGrid(nn=NN))
        masks = [N[:: 2**l, :: 2**l, :: 2**l] for l in range(len(grids))]
        scale = 1e-9 + rng.uniform(0.0, 1.0, size=grids[0].ne) ** 3
    else:
        KEs = [helmholtz_element_matrices(*g.h, 0.05)[0] for g in grids]
        masks = None
        scale = np.ones(grids[0].ne)
    r = rng.normal(size=(*NN, dof))
    if masks is not None:
        r = r * masks[0]
    return grids, KEs, masks, scale.astype(np.float32), r.astype(np.float32)


def _both(dof, **kw):
    grids, KEs, masks, scale, r = _problem(dof)
    args = dict(smooth_sweeps=2 if dof == 1 else 4, **kw)
    port = GeometricMultigrid(grids, KEs, masks, dof, device=CPU, **args)
    jgrids = JaxGrid(nn=NN).hierarchy(len(grids))
    ref = JMG(jgrids, KEs, masks, dof, **args)
    return port, ref, scale, r


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        got.numpy(), ref, rtol=1e-5, atol=1e-6 * float(np.max(np.abs(ref)))
    )


@pytest.mark.parametrize("dof", [3, 1])
def test_setup_matches(dof):
    port, ref, scale, _ = _both(dof)
    got = port.setup(torch.from_numpy(scale))
    want = ref.setup(jnp.asarray(scale), ref.mask_args())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g["dinv"], w["dinv"])
        _close(g["lmax"], w["lmax"])
        _close(g["coef"], w["coef"])


@pytest.mark.parametrize("dof", [3, 1])
def test_vcycle_matches(dof):
    port, ref, scale, r = _both(dof)
    z = port.vcycle(port.setup(torch.from_numpy(scale)), torch.from_numpy(r))
    masks = ref.mask_args()
    zj = ref.vcycle(ref.setup(jnp.asarray(scale), masks), jnp.asarray(r))
    assert z.shape == (*NN, dof)
    _close(z, zj)
    # and the masked operator itself
    lv = port.setup(torch.from_numpy(scale))
    lj = ref.setup(jnp.asarray(scale), masks)
    _close(port.apply(0, lv[0]["coef"], torch.from_numpy(r)),
           ref.apply(0, lj[0]["coef"], jnp.asarray(r), masks))


def test_options_outside_the_port_raise():
    grids, KEs, masks, _, _ = _problem(3)
    with pytest.raises(NotImplementedError, match="item 14"):
        GeometricMultigrid(grids, KEs, masks, 3, device=CPU,
                           coarse_op="galerkin_octant")
