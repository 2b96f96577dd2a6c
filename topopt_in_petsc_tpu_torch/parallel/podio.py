"""Whole fields to and from rank 0 for IO: the JAX package's
`parallel/podio.py` (`gather_blocked`, `put_blocked`) over the rank grid.

`gather_elem` / `gather_nodal` bring every rank's block to rank 0 and
assemble the global field there (None on the other ranks); `scatter_elem`
/ `scatter_nodal` cut a global field held by rank 0 into the ranks'
blocks (nodal blocks with their shared planes).  Both run through
parallel/comm.py and are collective: every rank calls them.  The ranks of
a run share a host, so nothing goes through shard files.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from topopt_in_petsc_tpu_torch.parallel.comm import gather, scatter
from topopt_in_petsc_tpu_torch.parallel.decomp import BlockDecomp
from topopt_in_petsc_tpu_torch.parallel.mesh import RankMesh


def _blocked(mesh: RankMesh, t: torch.Tensor) -> Optional[np.ndarray]:
    blocks = gather(mesh, t)
    if blocks is None:
        return None
    return np.stack(blocks).reshape(*mesh.shape, *blocks[0].shape)


def gather_elem(mesh: RankMesh, decomp: BlockDecomp,
                t: torch.Tensor) -> Optional[np.ndarray]:
    """The global element field of the blocks t, on rank 0."""
    b = _blocked(mesh, t)
    return None if b is None else decomp.from_blocked_elem(b)


def gather_nodal(mesh: RankMesh, decomp: BlockDecomp,
                 t: torch.Tensor) -> Optional[np.ndarray]:
    """The global nodal field of the (consistent) blocks t, on rank 0."""
    b = _blocked(mesh, t)
    return None if b is None else decomp.from_blocked_nodal(b)


def _scatter(mesh: RankMesh, blocked: Optional[np.ndarray], shape,
             dtype) -> torch.Tensor:
    blocks = None
    if blocked is not None:
        blocks = list(blocked.reshape(mesh.world, *blocked.shape[3:]))
    return scatter(mesh, blocks, shape, dtype)


def scatter_elem(mesh: RankMesh, decomp: BlockDecomp,
                 arr: Optional[np.ndarray], dtype) -> torch.Tensor:
    """This rank's block of the global element field `arr` (given on
    rank 0)."""
    blocked = None if arr is None else decomp.to_blocked_elem(arr)
    return _scatter(mesh, blocked, decomp.local_ne(0), dtype)


def scatter_nodal(mesh: RankMesh, decomp: BlockDecomp,
                  arr: Optional[np.ndarray], dtype) -> torch.Tensor:
    """This rank's block of the global nodal (nx, ny, nz, dof) field `arr`
    (given on rank 0; dof 3)."""
    blocked = None if arr is None else decomp.to_blocked_nodal(arr)
    return _scatter(mesh, blocked, (*decomp.local_nn(0), 3), dtype)
