"""Geometric multigrid on the structured hex grid: the transfers and the
nodal-layout V-cycle preconditioner.

Separable trilinear interpolation (the reference's DMCreateInterpolation,
LinearElasticity.cc:704), restriction as its exact adjoint (R = P^T), and
2x2x2 averaging of element fields for the rediscretized coarse operators.

`prolong` and `restrict` act on three spatial axes of any field: the nodal
``(nx, ny, nz, dof)`` layout (axes 0-2, the default) or the resident
``(dof, nx, ny, nz)`` layout (axes 1-3).

`GeometricMultigrid` is the JAX package's class of the same name on the
nodal layout (reference PCMG stacks, LinearElasticity.cc:654-746 and
PDEFilter.cc:290-380): Chebyshev-Jacobi smoothing, rediscretized coarse
operators, a Jacobi-PCG coarse solve, and optional per-level Dirichlet
masks.  Every level's operator is a hand-written kernel
(ops/nodal_hex.py): K3 for dof 1 (the PDE filter), K4 for dof 3 (the
nodal elasticity solve).  `precond_dtype` bf16 runs the whole V-cycle on
bf16 vectors, masks and Jacobi diagonals (the JAX package's
reduced-precision V-cycle), with the eigenvalue bound and K4's element
coefficient kept f32: K4 widens its bf16 input and rounds its result.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from topopt_in_petsc_tpu_torch.ops.hex_operator import (
    hex_operator_absrowsum,
    hex_operator_diagonal,
)
from topopt_in_petsc_tpu_torch.ops.nodal_hex import (
    make_helmholtz_apply,
    make_nodal_hex_apply,
)
from topopt_in_petsc_tpu_torch.solvers.cg import pcg_x
from topopt_in_petsc_tpu_torch.solvers.chebyshev import (
    chebyshev_smooth,
    gershgorin_lambda_max,
)


def _axis_slice(ndim: int, axis: int, sl: slice):
    idx = [slice(None)] * ndim
    idx[axis] = sl
    return tuple(idx)


def _interp_axis(u: torch.Tensor, axis: int) -> torch.Tensor:
    """Linear interpolation along one axis: size n -> 2n-1."""
    n = u.shape[axis]
    mid = 0.5 * (u.narrow(axis, 0, n - 1) + u.narrow(axis, 1, n - 1))
    shape = list(u.shape)
    shape[axis] = 2 * n - 1
    out = u.new_zeros(shape)
    out[_axis_slice(u.ndim, axis, slice(0, None, 2))] = u
    out[_axis_slice(u.ndim, axis, slice(1, None, 2))] = mid
    return out


def prolong(uc: torch.Tensor, axes=(0, 1, 2)) -> torch.Tensor:
    """Coarse (ncx, ncy, ncz) -> fine (2ncx-1, ...) trilinear."""
    u = uc
    for axis in axes:
        u = _interp_axis(u, axis)
    return u


def _restrict_axis(f: torch.Tensor, axis: int) -> torch.Tensor:
    """Adjoint of _interp_axis: c[i] = f[2i] + 0.5 f[2i-1] + 0.5 f[2i+1]."""
    c = f[_axis_slice(f.ndim, axis, slice(0, None, 2))].clone()
    mid = 0.5 * f[_axis_slice(f.ndim, axis, slice(1, None, 2))]
    c[_axis_slice(f.ndim, axis, slice(1, None))] += mid
    c[_axis_slice(f.ndim, axis, slice(None, -1))] += mid
    return c


def restrict(rf: torch.Tensor, axes=(0, 1, 2)) -> torch.Tensor:
    """Fine -> coarse residual transfer, exact transpose of `prolong`."""
    r = rf
    for axis in axes:
        r = _restrict_axis(r, axis)
    return r


def coarsen_cell_field(E: torch.Tensor) -> torch.Tensor:
    """2x2x2 arithmetic average of a per-element field (8-child averaging
    of the SIMP-scaled stiffness), summed x, then y, then z pairs."""
    ex, ey, ez = E.shape
    E = E.reshape(ex // 2, 2, ey, ez).sum(dim=1)
    E = E.reshape(ex // 2, ey // 2, 2, ez).sum(dim=2)
    E = E[..., 0::2] + E[..., 1::2]
    return E * 0.125


class GeometricMultigrid:
    """V-cycle preconditioner for the masked hex operator, f32 at every
    level, or bf16 (`precond_dtype`, the preconditioner's vectors only).

    grids: fine-to-coarse Grid hierarchy (length nlvls).
    KEs:   per-level (8 dof, 8 dof) element matrices (numpy).
    masks: per-level (nx, ny, nz, dof) 0/1 Dirichlet masks (numpy), or
           None (a pure Neumann problem: the Helmholtz filter).
    """

    def __init__(
        self,
        grids: Sequence,
        KEs: Sequence[np.ndarray],
        masks: Optional[Sequence[np.ndarray]],
        dof: int,
        *,
        device: torch.device,
        smooth_sweeps: int = 4,
        cheby_lower: float = 0.06,
        cheby_upper: float = 1.1,
        coarse_rtol: float = 1e-8,
        coarse_maxit: int = 30,
        precise_dots: bool = True,
        coarse_op: str = "rediscretize",
        precond_dtype=None,
    ):
        if coarse_op != "rediscretize":
            raise NotImplementedError(
                f"coarse_op {coarse_op!r} is not ported yet "
                "(ROADMAP.md queue 1 item 14)"
            )
        # the dtype of the V-cycle's vectors and Jacobi diagonals
        self.vdt = precond_dtype or torch.float32
        self.grids = tuple(grids)
        self.nlvls = len(self.grids)
        f32 = dict(dtype=torch.float32, device=torch.device(device))
        self.KEs = [torch.as_tensor(np.asarray(k), **f32) for k in KEs]
        make = {1: make_helmholtz_apply, 3: make_nodal_hex_apply}[dof]
        self.level_applies = [
            make(g.nn, KEs[l]) for l, g in enumerate(self.grids)
        ]
        # per vector dtype: the per-level masks N and 1 - N
        self._masks = None
        if masks is not None:
            N = [torch.as_tensor(m, **f32) for m in masks]
            self._masks = {
                dt: ([m.to(dt) for m in N], [(1.0 - m).to(dt) for m in N])
                for dt in {torch.float32, self.vdt}
            }
        self.smooth_sweeps = smooth_sweeps
        self.cheby_lower = cheby_lower
        self.cheby_upper = cheby_upper
        self.coarse_rtol = coarse_rtol
        self.coarse_maxit = coarse_maxit
        self.precise_dots = precise_dots

    def apply(self, level: int, coef: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
        """A_l v = N (K_l (N v)) + (I - N) v (LinearElasticity.cc:530-538,
        applied matrix-free at every level); `coef` is the level's
        prepared element coefficient (`setup`)."""
        ap = self.level_applies[level]
        if self._masks is None:
            return ap.apply_prepared(v.contiguous(), coef)
        masks, unmasks = self._masks[v.dtype]
        N = masks[level]
        Kv = ap.apply_prepared(N * v, coef)
        return N * Kv + unmasks[level] * v

    def setup(self, scale_fine: torch.Tensor) -> List[dict]:
        """Per-level {coef, dinv, lmax} from the fine element scale: coef
        and lmax f32, dinv in the V-cycle's dtype.  lmax is the certain
        Gershgorin bound; masked rows are identity rows (diagonal 1, ratio
        1)."""
        levels = []
        E = scale_fine.to(torch.float32)
        for l, g in enumerate(self.grids):
            if l > 0:
                E = coarsen_cell_field(E)
            d = hex_operator_diagonal(E, self.KEs[l], g.nn)
            mask = None
            if self._masks is not None:
                masks, unmasks = self._masks[torch.float32]
                mask = masks[l]
                d = mask * d + unmasks[l]
            R = hex_operator_absrowsum(E, self.KEs[l], g.nn)
            levels.append({
                "coef": self.level_applies[l].prepare_coef(E),
                "dinv": (1.0 / d).to(self.vdt),
                "lmax": gershgorin_lambda_max(R, d, mask),
            })
        return levels

    def vcycle(self, levels: List[dict], b: torch.Tensor,
               level: int = 0, *, predicated: bool = False) -> torch.Tensor:
        """One multiplicative V(s,s) cycle; returns z ~= A^-1 b.  With
        `predicated` the coarse CG runs all its `coarse_maxit` trips and
        reads nothing back from the device."""
        lvl = levels[level]
        A = lambda v: self.apply(level, lvl["coef"], v)  # noqa: E731

        if level == self.nlvls - 1:
            return pcg_x(
                A, b, torch.zeros_like(b), lambda r: lvl["dinv"] * r,
                predicated=predicated, rtol=self.coarse_rtol,
                maxiter=self.coarse_maxit, flexible=False,
                precise_dots=self.precise_dots,
            )

        def smooth(bb, xx, **kw):
            return chebyshev_smooth(
                A, bb, xx, lvl["dinv"], lvl["lmax"],
                degree=self.smooth_sweeps,
                lower=self.cheby_lower, upper=self.cheby_upper, **kw,
            )

        # presmooth from zero: skip the A(0) application
        x = smooth(b, b, x_is_zero=True)
        r = b - A(x)
        rc = self._masked(level + 1, restrict(r))
        ec = self.vcycle(levels, rc, level + 1, predicated=predicated)
        x = x + self._masked(level, prolong(ec))
        return smooth(b, x)

    def _masked(self, level: int, v: torch.Tensor) -> torch.Tensor:
        return v if self._masks is None else \
            self._masks[v.dtype][0][level] * v

    def preconditioner(self, levels: List[dict], *,
                       predicated: bool = False) -> Callable:
        """The V-cycle as M: on r cast to the V-cycle's dtype, its result
        cast back; `predicated` for the predicated solves of the fused
        step, eager for the split driver's."""
        vdt = self.vdt
        return lambda r: self.vcycle(
            levels, r.to(vdt), predicated=predicated).to(r.dtype)
