"""The halo engine of `-mesh_shape`, port against the JAX package, at 2
ranks (mesh (2,1,1)) and 8 ranks (mesh (2,2,2)).

The port's functions run on ranks started by its own launcher
(`parallel/multihost.py::spawn`, `-device cpu`); the JAX functions run in
this process under `shard_map` on the virtual CPU devices of
tests/conftest.py.  Both take the same numpy input, in float64, and are
held to `tests/test_spmd.py`'s bar, rtol 1e-12: halo accumulation on the
nodal layout and on the resident ``(3, nx, ny, nz)`` layout, the element
ghost fill, and the SPMD restriction, whose blocks are held to the JAX
package's restriction of the whole field (its `restrict_spmd` under
`shard_map` takes several seconds to compile).  Also: the decomposition against the
JAX package's, and the sums the ranks reduce being the same bits on every
rank (the Krylov loops stop on them).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from topopt_in_petsc_tpu.grid import Grid as JaxGrid
from topopt_in_petsc_tpu.parallel.decomp import BlockDecomp as JaxDecomp
from topopt_in_petsc_tpu.parallel.mesh import make_device_mesh
from topopt_in_petsc_tpu.parallel import spmd as jspmd
from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.ops.hex_operator import scatter_element_dofs
from topopt_in_petsc_tpu_torch.parallel import spmd
from topopt_in_petsc_tpu_torch.parallel.comm import allreduce_sum
from topopt_in_petsc_tpu_torch.parallel.decomp import BlockDecomp
from topopt_in_petsc_tpu_torch.parallel.multihost import spawn

torch.set_num_threads(1)

MESHES = [(2, 1, 1), (2, 2, 2)]
NN = (9, 9, 9)


def _jax_run(fn, mesh_shape, blocked):
    """fn(local block) under shard_map over the JAX mesh of that shape."""
    n = int(np.prod(mesh_shape))
    mesh = make_device_mesh(mesh_shape, jax.devices()[:n])

    @partial(shard_map, mesh=mesh, in_specs=P(*jspmd.AXIS_NAMES),
             out_specs=P(*jspmd.AXIS_NAMES), check_vma=False)
    def run(b):
        return jspmd.unpeel(fn(jspmd.peel(b)))

    return np.asarray(run(jnp.asarray(blocked)))


def _blocks(blocked, mesh_shape):
    """The per-rank blocks of a blocked array, in rank order."""
    return [blocked[c] for c in np.ndindex(*mesh_shape)]


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_decomposition_matches_jax(mesh_shape):
    d = BlockDecomp(Grid(nn=(17, 9, 9)), mesh_shape, nlvls=2)
    j = JaxDecomp(JaxGrid(nn=(17, 9, 9)), mesh_shape, nlvls=2)
    rng = np.random.default_rng(0)
    nodal = rng.normal(size=(17, 9, 9, 3))
    elem = rng.normal(size=(16, 8, 8))
    for level in (0, 1):
        assert d.local_nn(level) == j.local_nn(level)
        blk = d.to_blocked_nodal(nodal[::2**level, ::2**level, ::2**level],
                                 level)
        ref = j.to_blocked_nodal(nodal[::2**level, ::2**level, ::2**level],
                                 level)
        np.testing.assert_array_equal(blk, ref)
        np.testing.assert_array_equal(d.from_blocked_nodal(blk, level),
                                      j.from_blocked_nodal(ref, level))
        offs = j.origin_offsets(level)
        for c in np.ndindex(*mesh_shape):
            assert d.origin(c, level) == tuple(offs[c])
            # owned_start: the first local index whose JAX ownership
            # weight is 1 on each axis
            w = j.ownership_weights(level, 1)[c][..., 0]
            start = d.owned_start(c)
            assert w[start].all() and (w.sum() == np.prod(
                [n - s for n, s in zip(w.shape, start)]))
    eb = d.to_blocked_elem(elem)
    np.testing.assert_array_equal(eb, j.to_blocked_elem(elem))
    np.testing.assert_array_equal(d.from_blocked_elem(eb), elem)


def _scatter_input(mesh_shape, dof, seed):
    """Per-element dofs (global), and each rank's local scatter of its
    block: the partial sums `halo_accumulate` completes."""
    d = BlockDecomp(Grid(nn=NN), mesh_shape, nlvls=1)
    rng = np.random.default_rng(seed)
    fe = rng.normal(size=(8, 8, 8, 8 * dof))
    fe_blk = d.to_blocked_elem(fe)
    parts = [scatter_element_dofs(torch.as_tensor(b), d.local_nn(0))
             for b in _blocks(fe_blk, mesh_shape)]
    return d, fe_blk, parts


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("layout", ["nodal", "resident"])
def test_halo_accumulate_matches_jax(mesh_shape, layout):
    """The partial sums of each rank's local scatter, completed by JAX
    `halo_accumulate` and by the port's on either layout."""
    d, fe_blk, parts = _scatter_input(mesh_shape, 3, seed=1)
    blocked = np.stack([p.numpy() for p in parts]).reshape(
        *mesh_shape, *parts[0].shape)
    ref = _jax_run(lambda u: jspmd.halo_accumulate(u, mesh_shape),
                   mesh_shape, blocked)
    if layout == "nodal":
        args = [(p, spmd.NODAL) for p in parts]
    else:
        args = [(p.permute(3, 0, 1, 2).contiguous(), (1, 2, 3))
                for p in parts]
    got = spawn(mesh_shape, spmd.halo_accumulate, args)
    for c, g in zip(np.ndindex(*mesh_shape), got):
        if layout == "resident":
            g = np.moveaxis(g, 0, -1)
        np.testing.assert_allclose(g, ref[c], rtol=1e-12, atol=1e-12)
    # the scatter over the whole grid, block by block (shared planes
    # consistent)
    from topopt_in_petsc_tpu.ops.hex_operator import (
        scatter_element_dofs as jscatter,
    )

    whole = np.asarray(jscatter(jnp.asarray(d.from_blocked_elem(fe_blk)),
                                NN))
    for c in np.ndindex(*mesh_shape):
        np.testing.assert_allclose(ref[c], d.local_nodal(whole, c),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_ghost_fill_matches_jax(mesh_shape):
    d = BlockDecomp(Grid(nn=NN), mesh_shape, nlvls=1)
    rng = np.random.default_rng(2)
    x_blk = d.to_blocked_elem(rng.normal(size=(8, 8, 8)))
    w = 2
    ref = _jax_run(lambda x: jspmd.ghost_fill_elem(x, w, mesh_shape),
                   mesh_shape, x_blk)
    got = spawn(mesh_shape, spmd.ghost_fill_elem,
                [(torch.as_tensor(b), w)
                 for b in _blocks(x_blk, mesh_shape)])
    for c, g in zip(np.ndindex(*mesh_shape), got):
        np.testing.assert_allclose(g, ref[c], rtol=1e-12, atol=0)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_restrict_matches_jax(mesh_shape):
    """Each rank's coarse block equals its window of the JAX package's
    restriction of the whole field (`test_spmd.py`'s check)."""
    from topopt_in_petsc_tpu.solvers.multigrid import restrict

    d = BlockDecomp(Grid(nn=NN), mesh_shape, nlvls=2)
    rng = np.random.default_rng(3)
    f = rng.normal(size=(*NN, 3))
    ref = np.asarray(restrict(jnp.asarray(f)))
    got = spawn(mesh_shape, spmd.restrict_spmd,
                [(torch.as_tensor(b),)
                 for b in _blocks(d.to_blocked_nodal(f), mesh_shape)])
    for c, g in zip(np.ndindex(*mesh_shape), got):
        np.testing.assert_allclose(g, d.local_nodal(ref, c, level=1),
                                   rtol=1e-12, atol=1e-12)


def test_reduced_sums_are_the_same_bits_on_every_rank():
    """Every rank gets the same bits from `allreduce_sum` (the loops that
    stop on a reduced value take the same trips on every rank)."""
    rng = np.random.default_rng(4)
    parts = rng.normal(size=(8, 5)) * 10.0 ** rng.integers(-8, 8, (8, 5))
    got = spawn((2, 2, 2), allreduce_sum,
                [(torch.as_tensor(p),) for p in parts])
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], parts.sum(axis=0), rtol=1e-14)
