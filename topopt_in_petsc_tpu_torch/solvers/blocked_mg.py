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

The V-cycle may store its levels in bf16 (`mg_dtype`, the JAX package's
reduced-precision V-cycle): every bf16 level runs K1's bf16-storage build,
and the outer Krylov keeps a separate f32 fine operator (`op32`), so the
true residual stays f32.  "mixed" stores the fine level f32 and the coarse
levels bf16.  With a bf16 level the outer PCG also keeps its search
direction and the flexible beta's ``A p`` in bf16 (`krylov_compress`), and
`fine_post_smooth` appends an f32 Chebyshev refinement on `op32` to each
bf16 V-cycle.

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
    """Resident-layout geometric-MG PCG for the cantilever problem.

    mg_dtype: None (f32 at every level), torch.bfloat16 (every level) or
    "mixed" (f32 fine level, bf16 coarse levels).  fine_post_smooth: the
    degree of the f32 Chebyshev refinement appended to a V-cycle whose
    fine level is bf16 (0 = none; no effect otherwise)."""

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
        mg_dtype=None,
        fine_post_smooth: int = 0,
    ):
        self.grids = tuple(grids)
        self.nlvls = len(self.grids)
        self.device = torch.device(device)
        self.KEs = [
            torch.as_tensor(np.asarray(k), dtype=torch.float32,
                            device=self.device)
            for k in KEs
        ]
        f32 = torch.float32
        if mg_dtype == "mixed":
            self.level_dtypes = [f32] + [torch.bfloat16] * (self.nlvls - 1)
        else:
            self.level_dtypes = [mg_dtype or f32] * self.nlvls
        self.mg_dtype = self.level_dtypes[0]
        self.ops: List[BlockedHexOperator] = [
            BlockedHexOperator(g.nn, KEs[l], device=self.device,
                               dtype=self.level_dtypes[l])
            for l, g in enumerate(self.grids)
        ]
        # the outer Krylov's operator: f32, the fine level's own when that
        # level is f32
        self.op32 = self.ops[0] if self.mg_dtype == f32 else \
            BlockedHexOperator(self.grids[0].nn, KEs[0], device=self.device)
        # the dtype of the outer PCG's carried search direction and kept
        # A p: bf16 when a level is
        self.krylov_compress = (torch.bfloat16 if any(
            d != f32 for d in self.level_dtypes) else None)
        self.fine_post_smooth = (
            fine_post_smooth if self.op32 is not self.ops[0] else 0)
        self.smooth_sweeps = smooth_sweeps
        self.cheby_lower = cheby_lower
        self.cheby_upper = cheby_upper
        self.coarse_rtol = coarse_rtol
        self.coarse_maxit = coarse_maxit
        self.precise = precise_dots

    # -- per-solve setup ------------------------------------------------ #

    def setup(self, E_fine: torch.Tensor) -> List[dict]:
        """Per-level {eb, dinv, lmax} from the fine SIMP scale, eb and dinv
        in the level's dtype, lmax f32; level 0 also has the f32 `eb32` of
        `op32` when the fine level is bf16.  The x == 0 rows get diagonal
        1 and Gershgorin ratio 1 (identity rows)."""
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
            if l == 0 and self.op32 is not op:
                levels[0]["eb32"] = self.op32.prepare_coef(E)
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
        # each transfer in the dtype of the level it leaves
        opc = self.ops[l + 1]
        rc = opc.mask0(restrict(r, _SPATIAL).to(opc.dtype))
        ec = self.vcycle(levels, rc, l + 1, predicated=predicated)
        x = x + op.mask0(prolong(ec, _SPATIAL).to(op.dtype))
        return smooth(b, x)

    # -- outer solve ---------------------------------------------------- #

    def _outer_ops(self, levels: List[dict], predicated: bool = False):
        """(A, M, dot) of the outer Krylov: the f32 operator `op32` and one
        V-cycle, run in the V-cycle's dtype and its result widened, then
        refined by `fine_post_smooth` f32 Chebyshev steps."""
        op32 = self.op32

        def V(r):
            return self.vcycle(levels, r, predicated=predicated)

        def dot(a, b):
            return op32.dot(a, b, self.precise)

        if op32 is self.ops[0]:
            return self._A(0, levels[0]["eb"]), V, dot
        eb32 = levels[0]["eb32"]

        def A(v):
            return op32.apply(v, eb32)

        def M(r):
            z = V(r.to(self.mg_dtype)).to(r.dtype)
            if self.fine_post_smooth > 0:
                # bf16 rounding noise in z is spectrally flat; a short
                # f32 Chebyshev-Jacobi step on op32 damps its
                # high-frequency part (unsymmetric, which the flexible
                # outer PCG tolerates)
                z = chebyshev_smooth(
                    A, r, z, levels[0]["dinv"].to(r.dtype),
                    levels[0]["lmax"], degree=self.fine_post_smooth,
                    lower=self.cheby_lower, upper=self.cheby_upper,
                )
            return z

        return A, M, dot

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
        solution are f32 resident tensors, `op32`'s).  ksp_type "fcg"
        (flexible PCG) or "cg" (standard PCG)."""
        levels = self.setup(E_fine)
        A, M, dot = self._outer_ops(levels)
        return pcg(
            A, b_blk, x0_blk, M, rtol=rtol, maxiter=maxiter,
            flexible=(ksp_type != "cg"), dot=dot,
            compress=self.krylov_compress,
        )

    def start(self, E_fine: torch.Tensor, b_blk: torch.Tensor,
              x0_blk: torch.Tensor) -> Tuple[List[dict], PCGState]:
        """The MG setup and the Krylov carry of `solve` before its first
        iteration."""
        levels = self.setup(E_fine)
        A, M, dot = self._outer_ops(levels, predicated=True)
        return levels, pcg_start(A, b_blk, x0_blk, M, dot=dot,
                                 compress=self.krylov_compress)

    def advance(self, levels: List[dict], state: PCGState, n: int, *,
                rtol: float = 1e-5, maxiter: int = 200,
                ksp_type: str = "fcg") -> PCGState:
        """n predicated iterations of `solve` from `state`."""
        A, M, dot = self._outer_ops(levels, predicated=True)
        return pcg_trips(
            A, state, M, n, rtol=rtol, maxiter=maxiter,
            flexible=(ksp_type != "cg"), dot=dot,
            compress=self.krylov_compress,
        )
