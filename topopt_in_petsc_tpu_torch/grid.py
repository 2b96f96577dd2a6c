"""Structured hex grid geometry (numpy only).

Replacement for the two co-partitioned PETSc DMDAs the reference builds in
TopOpt::SetUpMESH (TopOpt.cc:233-300): a nodal box grid of ``(nx, ny, nz)``
nodes and an element grid of ``(nx-1, ny-1, nz-1)`` cells.  Every field is a
dense tensor on one device, so the two grids are co-located by
construction.

Array layout conventions used across the framework:
  - nodal fields:   shape ``(nx, ny, nz, dof)``   (dof=3 elasticity, 1 filter)
  - element fields: shape ``(nx-1, ny-1, nz-1)``
Hex-corner local ordering matches the reference's Hex8 node ordering
(LinearElasticity.cc:118-120 X/Y/Z tables, DMDAGetElements_3D cell order
LinearElasticity.cc:819-826):

  corner:   0       1       2       3       4       5       6       7
  offset: (0,0,0) (1,0,0) (1,1,0) (0,1,0) (0,0,1) (1,0,1) (1,1,1) (0,1,1)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Local hex-corner offsets, reference node ordering (LinearElasticity.cc:118).
CORNER_OFFSETS: Tuple[Tuple[int, int, int], ...] = (
    (0, 0, 0),
    (1, 0, 0),
    (1, 1, 0),
    (0, 1, 0),
    (0, 0, 1),
    (1, 0, 1),
    (1, 1, 1),
    (0, 1, 1),
)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Geometry of one structured grid level."""

    nn: Tuple[int, int, int]  # nodes per axis
    lo: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    hi: Tuple[float, float, float] = (2.0, 1.0, 1.0)

    @classmethod
    def from_config(cls, cfg) -> "Grid":
        return cls(
            nn=(cfg.nx, cfg.ny, cfg.nz),
            lo=(cfg.xcmin, cfg.ycmin, cfg.zcmin),
            hi=(cfg.xcmax, cfg.ycmax, cfg.zcmax),
        )

    @property
    def ne(self) -> Tuple[int, int, int]:
        return (self.nn[0] - 1, self.nn[1] - 1, self.nn[2] - 1)

    @property
    def nelem(self) -> int:
        ex, ey, ez = self.ne
        return ex * ey * ez

    @property
    def nnode(self) -> int:
        return self.nn[0] * self.nn[1] * self.nn[2]

    @property
    def h(self) -> Tuple[float, float, float]:
        """Element edge lengths (dx, dy, dz) — TopOpt.cc:228-230."""
        return tuple(
            (self.hi[a] - self.lo[a]) / (self.nn[a] - 1) for a in range(3)
        )

    @property
    def elem_volume(self) -> float:
        dx, dy, dz = self.h
        return dx * dy * dz

    def node_coords(self, dtype=np.float64) -> np.ndarray:
        """(nx, ny, nz, 3) physical node coordinates (host-side; setup only)."""
        axes = [
            np.linspace(self.lo[a], self.hi[a], self.nn[a], dtype=dtype)
            for a in range(3)
        ]
        X, Y, Z = np.meshgrid(*axes, indexing="ij")
        return np.stack([X, Y, Z], axis=-1)

    def elem_center_coords(self, dtype=np.float64) -> np.ndarray:
        """(ex, ey, ez, 3) element-center coordinates (TopOpt.cc:298-299)."""
        h = self.h
        axes = [
            np.linspace(
                self.lo[a] + h[a] / 2, self.hi[a] - h[a] / 2, self.ne[a],
                dtype=dtype,
            )
            for a in range(3)
        ]
        X, Y, Z = np.meshgrid(*axes, indexing="ij")
        return np.stack([X, Y, Z], axis=-1)

    # ------------------------------------------------------------- #
    # Multigrid hierarchy

    def can_coarsen(self) -> bool:
        return all(e % 2 == 0 and e >= 2 for e in self.ne)

    def coarsen(self) -> "Grid":
        """2h grid: halve every element axis (DMCoarsenHierarchy equivalent,
        LinearElasticity.cc:689)."""
        if not self.can_coarsen():
            raise ValueError(f"grid {self.nn} cannot be coarsened")
        return Grid(
            nn=tuple(e // 2 + 1 for e in self.ne), lo=self.lo, hi=self.hi
        )

    def hierarchy(self, nlvls: int) -> Tuple["Grid", ...]:
        """Fine-to-coarse grid list of length nlvls (level 0 = finest)."""
        grids = [self]
        for _ in range(nlvls - 1):
            grids.append(grids[-1].coarsen())
        return tuple(grids)
