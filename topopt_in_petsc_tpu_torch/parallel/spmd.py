"""The halo engine of `-mesh_shape`: the JAX package's `parallel/spmd.py`
over the ranks of parallel/mesh.py, one overlapping block each
(parallel/decomp.py).

- `halo_accumulate`: completes the scatter-adds of a local operator on
  the duplicated planes, one plane exchange per axis, axis after axis, so
  that edge and corner nodes add up (DMGlobalToLocal / VecScatter of the
  reference, LinearElasticity.cc:249).  It works on any layout: the
  spatial axes of the nodal ``(nx, ny, nz, dof)`` field are (0, 1, 2), of
  the resident ``(3, nx, ny, nz)`` one (1, 2, 3).
- `ghost_fill_elem`: widens an element block by `width` ghost layers for
  the filter convolution (Filter.cc:326-368).
- `make_dot`: the global inner product of consistent vectors: the owned
  nodes only (`BlockDecomp.owned_start`), f32 products summed in f64 as
  `solvers/cg._dot`, then summed over the ranks (the reference's
  MPI_Allreduce dots); the Krylov loops take their dots of one step in
  one reduction (`dot.many`).
- `restrict_spmd`: the weighted restriction, with the shared plane's
  centre term counted by its owner only; `prolong` needs nothing from the
  neighbours.
- `MeshBlock`: these operations as the hooks of the single-device
  solvers (solvers/multigrid.py `OneBlock`), which run on the rank's
  block through them: the nodal V-cycle (the JAX package's
  `SpmdMultigrid`), the resident one (its `BlockedSpmdMG`) and the PDE
  filter (its `SpmdPDEFilter`).  The cantilever's clamped wall (the
  global x = 0 plane) lies on the ranks at x-coordinate 0 only.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from topopt_in_petsc_tpu_torch.parallel.comm import (
    allreduce_max,
    allreduce_sum,
    exchange,
)
from topopt_in_petsc_tpu_torch.parallel.decomp import BlockDecomp
from topopt_in_petsc_tpu_torch.parallel.mesh import RankMesh
from topopt_in_petsc_tpu_torch.solvers.cg import _dot
from topopt_in_petsc_tpu_torch.solvers.multigrid import (
    NODAL,
    OneBlock,
    _axis_slice,
)


def halo_accumulate_axis(mesh: RankMesh, u: torch.Tensor, a: int,
                         ax: int) -> torch.Tensor:
    """Complete the partial sums on the two duplicated planes of mesh axis
    `a` (tensor axis `ax`), in place: both copies of a shared plane end up
    holding the same total."""
    if mesh.shape[a] == 1:
        return u
    n = u.shape[ax]
    from_lower, from_higher = exchange(mesh, a, u.select(ax, 0),
                                       u.select(ax, n - 1))
    if from_higher is not None:
        u.select(ax, n - 1).add_(from_higher)
    if from_lower is not None:
        u.select(ax, 0).add_(from_lower)
    return u


def halo_accumulate(mesh: RankMesh, u: torch.Tensor,
                    axes: Sequence[int] = NODAL) -> torch.Tensor:
    """`halo_accumulate_axis` on x, then y, then z; in place."""
    for a, ax in enumerate(axes):
        halo_accumulate_axis(mesh, u, a, ax)
    return u


def ghost_fill_elem(mesh: RankMesh, x: torch.Tensor,
                    width: int) -> torch.Tensor:
    """The element block widened by `width` layers per side per axis: the
    neighbours' layers, or zeros at the domain's edge (the zero padding of
    the global convolution); axis after axis, so corners fill through."""
    if width == 0:
        return x
    for a in range(3):
        n = x.shape[a]
        to_lower, to_higher = x.narrow(a, 0, width), \
            x.narrow(a, n - width, width)
        if mesh.shape[a] == 1:
            from_lower = from_higher = None
        else:
            from_lower, from_higher = exchange(mesh, a, to_lower, to_higher)
        zeros = torch.zeros_like(to_lower)
        x = torch.cat([zeros if from_lower is None else from_lower, x,
                       zeros if from_higher is None else from_higher], a)
    return x


def owned(mesh: RankMesh, v: torch.Tensor,
          axes: Sequence[int] = NODAL) -> torch.Tensor:
    """The view of v on the nodes this rank owns: its low plane on an axis
    only where it is first on that axis."""
    idx = [slice(None)] * v.ndim
    for ax, start in zip(axes, BlockDecomp.owned_start(mesh.coords)):
        idx[ax] = slice(start, None)
    return v[tuple(idx)]


def make_dot(mesh: RankMesh, precise: bool = True,
             axes: Sequence[int] = NODAL):
    """The global inner product of consistent vectors: the local dot of
    the owned nodes, summed over the ranks."""

    def local(a, b):
        return _dot(owned(mesh, a, axes), owned(mesh, b, axes), precise)

    def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return allreduce_sum(mesh, local(a, b))

    def many(pairs):
        """Several dots in one reduction (solvers/cg.py `_dots`)."""
        return list(allreduce_sum(
            mesh, torch.stack([local(a, b) for a, b in pairs])))

    dot.many = many
    return dot


def _restrict_axis_spmd(mesh: RankMesh, f: torch.Tensor, a: int,
                        ax: int) -> torch.Tensor:
    """c[i] = f[2i] + 0.5 (f[2i-1] + f[2i+1]) along one axis on
    overlapping blocks: the shared plane's centre term counts on its owner
    only, the half terms are local, and a plane exchange completes (and
    makes consistent again) the shared coarse planes."""
    c = f[_axis_slice(f.ndim, ax, slice(0, None, 2))].clone()
    if mesh.coords[a] > 0:
        c.select(ax, 0).zero_()
    mid = 0.5 * f[_axis_slice(f.ndim, ax, slice(1, None, 2))]
    c[_axis_slice(f.ndim, ax, slice(1, None))] += mid
    c[_axis_slice(f.ndim, ax, slice(None, -1))] += mid
    return halo_accumulate_axis(mesh, c, a, ax)


def restrict_spmd(mesh: RankMesh, r: torch.Tensor,
                  axes: Sequence[int] = NODAL) -> torch.Tensor:
    """Fine -> coarse residual transfer on overlapping blocks (the
    transpose of `prolong`, which is local)."""
    for a, ax in enumerate(axes):
        r = _restrict_axis_spmd(mesh, r, a, ax)
    return r


class MeshBlock(OneBlock):
    """The solvers' hooks (solvers/multigrid.py `OneBlock`) on this rank's
    block of `decomp`: the single-device solvers run on it unchanged."""

    # the JAX engine's filter applies its kernel under `auto` and `pallas`
    # only (spmd_pde_filter.py:57-80)
    plain_filter_impls = ("xla", "blocked")

    def __init__(self, mesh: RankMesh, decomp: BlockDecomp):
        self.mesh = mesh
        self.decomp = decomp
        # the clamped wall (the global x = 0 plane) is on the ranks at
        # x-coordinate 0 only
        self.wall = mesh.coords[0] == 0

    def hierarchy(self, grid, nlvls: int):
        """This rank's grids of the first min(nlvls, decomp.nlvls) levels
        (`grid` is the decomposition's)."""
        return [self.decomp.local_grid(self.mesh.coords, l)
                for l in range(min(nlvls, self.decomp.nlvls))]

    def kernel_levels(self, nlvls: int, on: bool) -> List[bool]:
        """The JAX engine's rule (`spmd_model.py:151-160`,
        `spmd_pde_filter.py:69-80`): the fine level, and a coarse level
        when the fine block's shortest side is at most 129 nodes and that
        level's at least 17."""
        nn = self.decomp.local_nn
        coarse = min(nn(0)) <= 129
        return [on and (l == 0 or (coarse and min(nn(l)) >= 17))
                for l in range(nlvls)]

    def complete(self, v: torch.Tensor, axes=NODAL) -> torch.Tensor:
        return halo_accumulate(self.mesh, v, axes)

    def restrict(self, r: torch.Tensor, axes=NODAL) -> torch.Tensor:
        return restrict_spmd(self.mesh, r, axes)

    def max(self, v: torch.Tensor) -> torch.Tensor:
        return allreduce_max(self.mesh, v)

    def dot(self, precise: bool, axes=NODAL):
        return make_dot(self.mesh, precise, axes)
