"""Overlapping-block domain decomposition of the multi-device engine: the
JAX package's `parallel/decomp.py` (numpy only; the port keeps its own
copy).

The global element grid (ex, ey, ez) splits evenly over the rank grid
(mx, my, mz); each rank owns the element block (ex/mx, ey/my, ez/mz) and
carries the *overlapping* nodal block (ex/mx + 1, ...): its elements'
corner nodes, with the shared planes duplicated between face neighbours
(PETSc's ghost nodes made explicit, TopOpt.cc:233-291).

Conventions:
 - duplicated planes hold identical values on both copies ("consistent"
   vectors); every operation of the engine keeps this so,
 - a shared plane is owned by the lower-coordinate rank (it is that
   rank's high plane), so a rank owns its local nodes from `owned_start`
   on: its low plane on an axis only where it is first on that axis;
   dots sum the owned nodes only, so each node counts once,
 - element blocks do not overlap.

The blocked layout of a global field has leading rank axes, nodal
(mx, my, mz, nxl, nyl, nzl, dof) or element (mx, my, mz, exl, eyl, ezl);
it is the layout of IO (parallel/podio.py) and of the tests.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from topopt_in_petsc_tpu_torch.grid import Grid


@dataclasses.dataclass(frozen=True)
class BlockDecomp:
    grid: Grid
    mesh_shape: Tuple[int, int, int]
    nlvls: int = 1

    def __post_init__(self):
        for a in range(3):
            e, m = self.grid.ne[a], self.mesh_shape[a]
            if e % m != 0:
                raise ValueError(
                    f"element count {e} (axis {a}) not divisible by mesh "
                    f"dim {m}"
                )
            el = e // m
            if el % (2 ** (self.nlvls - 1)) != 0:
                raise ValueError(
                    f"local element count {el} (axis {a}) not divisible by "
                    f"2^{self.nlvls - 1}; reduce nlvls or mesh dim"
                )

    # -- local shapes per MG level ------------------------------------ #

    def local_ne(self, level: int = 0) -> Tuple[int, int, int]:
        return tuple(
            self.grid.ne[a] // self.mesh_shape[a] // (2**level)
            for a in range(3)
        )

    def local_nn(self, level: int = 0) -> Tuple[int, int, int]:
        return tuple(e + 1 for e in self.local_ne(level))

    def level_grid(self, level: int) -> Grid:
        return self.grid.hierarchy(self.nlvls)[level]

    # -- one rank's view ----------------------------------------------- #

    def origin(self, coords, level: int = 0) -> Tuple[int, int, int]:
        """Global node index of the block origin of the rank at `coords`."""
        return tuple(int(c) * e for c, e in zip(coords, self.local_ne(level)))

    def local_grid(self, coords, level: int = 0) -> Grid:
        """The grid of the block of the rank at `coords` (its nodes, its
        place and the level's spacing)."""
        g = self.level_grid(level)
        o, n, h = self.origin(coords, level), self.local_nn(level), g.h
        lo = tuple(g.lo[a] + o[a] * h[a] for a in range(3))
        return Grid(nn=n, lo=lo,
                    hi=tuple(lo[a] + (n[a] - 1) * h[a] for a in range(3)))

    @staticmethod
    def owned_start(coords) -> Tuple[int, int, int]:
        """First owned local node index per axis: 1 where the low plane is
        the lower neighbour's, else 0."""
        return tuple(int(c > 0) for c in coords)

    def local_nodal(self, arr: np.ndarray, coords, level: int = 0):
        """The overlapping block of a global nodal (nx, ny, nz, ...) array."""
        o, n = self.origin(coords, level), self.local_nn(level)
        return arr[tuple(slice(o[a], o[a] + n[a]) for a in range(3))]

    # -- host-side layout conversions (setup / IO only) --------------- #

    def to_blocked_nodal(self, arr: np.ndarray, level: int = 0):
        """Global (nx, ny, nz, dof) -> blocked
        (mx, my, mz, nxl, nyl, nzl, dof) with overlapping planes."""
        out = np.empty((*self.mesh_shape, *self.local_nn(level),
                        *arr.shape[3:]), arr.dtype)
        for c in np.ndindex(*self.mesh_shape):
            out[c] = self.local_nodal(arr, c, level)
        return out

    def from_blocked_nodal(self, blocked: np.ndarray, level: int = 0):
        """Inverse of to_blocked_nodal (overlaps must be consistent)."""
        blocked = np.asarray(blocked)
        g = self.level_grid(level)
        out = np.empty((*g.nn, *blocked.shape[6:]), blocked.dtype)
        for c in np.ndindex(*self.mesh_shape):
            self.local_nodal(out, c, level)[...] = blocked[c]
        return out

    def to_blocked_elem(self, arr: np.ndarray, level: int = 0):
        """Global (ex, ey, ez, ...) -> (mx, my, mz, exl, eyl, ezl, ...)."""
        arr = np.asarray(arr)
        mx, my, mz = self.mesh_shape
        exl, eyl, ezl = self.local_ne(level)
        tail = arr.shape[3:]
        r = arr.reshape(mx, exl, my, eyl, mz, ezl, *tail)
        return np.ascontiguousarray(r.transpose(0, 2, 4, 1, 3, 5,
                                                *range(6, 6 + len(tail))))

    def from_blocked_elem(self, blocked: np.ndarray, level: int = 0):
        blocked = np.asarray(blocked)
        mx, my, mz = self.mesh_shape
        exl, eyl, ezl = self.local_ne(level)
        tail = blocked.shape[6:]
        r = blocked.transpose(0, 3, 1, 4, 2, 5,
                              *range(6, 6 + len(tail)))
        return np.ascontiguousarray(
            r.reshape(mx * exl, my * eyl, mz * ezl, *tail)
        )
