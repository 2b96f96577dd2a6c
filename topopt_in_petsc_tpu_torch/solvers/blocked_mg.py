"""MG-PCG state solver with all vectors resident in kernel K1's layout
(ops/blocked_hex.py) at every level.

Chebyshev smoothing, residuals, the coarse CG, the level transfers and the
outer Krylov loop all work on ``(3, nx, ny, nz)`` tensors; the nodal layout
appears only in the per-solve setup stencils (diagonal, Gershgorin bound).
Same solver semantics as the JAX package's `solvers/blocked_mg.py` (same
smoothers, rediscretized coarsening, Gershgorin bound and tolerances —
reference LinearElasticity.cc:619-746), specialised to the cantilever's
x = 0 clamped wall, so Dirichlet masks are index predicates.

Each level has its own rediscretized element matrix KE, which K1 takes
per call.

The outer solve is either one eager `pcg` call (`solve`, the split
driver) or the predicated form, `start` and then `advance` in segments
(the fused step).  The V-cycle's coarse CG follows its outer solve: eager
under `solve`, `coarse_maxit` predicated trips under `start`/`advance`,
so that their V-cycles never read the device from the host.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from topopt_in_petsc_tpu_torch.ops.blocked_hex import BlockedHexOperator
from topopt_in_petsc_tpu_torch.ops.hex_operator import (
    hex_operator_absrowsum,
    hex_operator_diagonal,
)
from topopt_in_petsc_tpu_torch.solvers.cg import (
    CGResult,
    PCGState,
    pcg,
    pcg_start,
    pcg_trips,
    pcg_x,
)
from topopt_in_petsc_tpu_torch.solvers.chebyshev import chebyshev_smooth
from topopt_in_petsc_tpu_torch.solvers.multigrid import (
    coarsen_cell_field,
    prolong,
    restrict,
)

_SPATIAL = (1, 2, 3)  # the grid axes of a resident (3, nx, ny, nz) vector


class BlockedElasticityMG:
    """Resident-layout geometric-MG PCG for the cantilever problem, f32 at
    every level."""

    def __init__(
        self,
        grids: Sequence,
        KEs: Sequence[np.ndarray],
        *,
        device: torch.device,
        smooth_sweeps: int = 4,
        cheby_lower: float = 0.06,
        cheby_upper: float = 1.1,
        coarse_rtol: float = 1e-8,
        coarse_maxit: int = 30,
        precise_dots: bool = True,
    ):
        self.grids = tuple(grids)
        self.nlvls = len(self.grids)
        self.device = torch.device(device)
        self.KEs = [
            torch.as_tensor(np.asarray(k), dtype=torch.float32,
                            device=self.device)
            for k in KEs
        ]
        self.ops: List[BlockedHexOperator] = [
            BlockedHexOperator(g.nn, KEs[l], device=self.device)
            for l, g in enumerate(self.grids)
        ]
        self.smooth_sweeps = smooth_sweeps
        self.cheby_lower = cheby_lower
        self.cheby_upper = cheby_upper
        self.coarse_rtol = coarse_rtol
        self.coarse_maxit = coarse_maxit
        self.precise = precise_dots

    # -- per-solve setup ------------------------------------------------ #

    def setup(self, E_fine: torch.Tensor) -> List[dict]:
        """Per-level {eb, dinv, lmax} from the fine SIMP scale.  The x == 0
        rows get diagonal 1 and Gershgorin ratio 1 (identity rows)."""
        levels = []
        E = E_fine.to(torch.float32)
        for l, g in enumerate(self.grids):
            if l > 0:
                E = coarsen_cell_field(E)
            d = hex_operator_diagonal(E, self.KEs[l], g.nn)
            R = hex_operator_absrowsum(E, self.KEs[l], g.nn)
            d[0] = 1.0
            ratio = R / d
            ratio[0] = 1.0
            op = self.ops[l]
            levels.append({
                "eb": op.prepare_coef(E),
                "dinv": op.to_blocked(1.0 / d),
                "lmax": torch.max(ratio),
            })
        return levels

    def _A(self, l: int, eb):
        op = self.ops[l]
        return lambda v: op.apply(v, eb)

    def _dot(self, l: int):
        op = self.ops[l]
        return lambda a, b: op.dot(a, b, self.precise)

    # -- V-cycle -------------------------------------------------------- #

    def vcycle(self, levels: List[dict], b: torch.Tensor, l: int = 0, *,
               predicated: bool = False) -> torch.Tensor:
        lvl = levels[l]
        op = self.ops[l]
        A = self._A(l, lvl["eb"])

        if l == self.nlvls - 1:
            return pcg_x(
                A, b, torch.zeros_like(b), lambda r: lvl["dinv"] * r,
                predicated=predicated, rtol=self.coarse_rtol,
                maxiter=self.coarse_maxit, flexible=False,
                dot=self._dot(l),
            )

        def smooth(bb, xx, **kw):
            return chebyshev_smooth(
                A, bb, xx, lvl["dinv"], lvl["lmax"],
                degree=self.smooth_sweeps,
                lower=self.cheby_lower, upper=self.cheby_upper, **kw,
            )

        x = smooth(b, b, x_is_zero=True)
        r = b - A(x)
        opc = self.ops[l + 1]
        rc = opc.mask0(restrict(r, _SPATIAL))
        ec = self.vcycle(levels, rc, l + 1, predicated=predicated)
        x = x + op.mask0(prolong(ec, _SPATIAL))
        return smooth(b, x)

    # -- outer solve ---------------------------------------------------- #

    def solve(
        self,
        E_fine: torch.Tensor,
        b_blk: torch.Tensor,
        x0_blk: torch.Tensor,
        *,
        rtol: float = 1e-5,
        maxiter: int = 200,
        ksp_type: str = "fcg",
    ) -> CGResult:
        """Solve K(E) u = b in the resident layout (b, x0 and the returned
        solution are resident tensors).  ksp_type "fcg" (flexible PCG) or
        "cg" (standard PCG)."""
        levels = self.setup(E_fine)
        return pcg(
            self._A(0, levels[0]["eb"]), b_blk, x0_blk,
            lambda r: self.vcycle(levels, r),
            rtol=rtol, maxiter=maxiter,
            flexible=(ksp_type != "cg"), dot=self._dot(0),
        )

    def start(self, E_fine: torch.Tensor, b_blk: torch.Tensor,
              x0_blk: torch.Tensor) -> Tuple[List[dict], PCGState]:
        """The MG setup and the Krylov carry of `solve` before its first
        iteration."""
        levels = self.setup(E_fine)
        return levels, pcg_start(
            self._A(0, levels[0]["eb"]), b_blk, x0_blk,
            lambda r: self.vcycle(levels, r, predicated=True),
            dot=self._dot(0),
        )

    def advance(self, levels: List[dict], state: PCGState, n: int, *,
                rtol: float = 1e-5, maxiter: int = 200,
                ksp_type: str = "fcg") -> PCGState:
        """n predicated iterations of `solve` from `state`."""
        return pcg_trips(
            self._A(0, levels[0]["eb"]), state,
            lambda r: self.vcycle(levels, r, predicated=True), n,
            rtol=rtol, maxiter=maxiter, flexible=(ksp_type != "cg"),
            dot=self._dot(0),
        )
