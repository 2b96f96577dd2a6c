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
PDEFilter.cc:290-380): Chebyshev-Jacobi smoothing, rediscretized or
octant-Galerkin coarse operators, a Jacobi-PCG coarse solve, and optional
per-level Dirichlet masks.  Each level's operator is chosen once, in the
constructor:

- a hand-written kernel (ops/nodal_hex.py) at every rediscretized level:
  K3 for dof 1 (the PDE filter), K4 for dof 3 (the nodal elasticity
  solve); f32 only;
- with `plain`, the plain torch operator `apply_hex_operator` at every
  rediscretized level, in the field dtype (the JAX package's XLA path:
  `-operator_impl xla`, `-dtype float64`);
- under `coarse_op="galerkin_octant"`, the octant-Galerkin form
  `apply_hex_operator_octant` on levels >= 1, plain torch on either route
  (the JAX package runs no kernel there either).

`dtype` is the field dtype (f32 or f64).  `precond_dtype` bf16 runs the
whole V-cycle on bf16 vectors, masks and Jacobi diagonals (the JAX
package's reduced-precision V-cycle), with the eigenvalue bound and the
element coefficients kept in the field dtype: K4 widens its bf16 input and
rounds its result, the plain forms compute in bf16 as the JAX package's
XLA forms do.

`OneBlock` holds the hooks by which a solver's vectors, kept on one block
of the grid, meet the rest of it: completing an operator's partial sums,
the restriction, reductions, the dot, the levels that run a kernel and
whether the block holds the clamped wall.  On one device the block is
the whole grid and every hook is the plain operation; under
`-mesh_shape` each rank passes its `parallel/spmd.py::MeshBlock` to the
same solvers (this class, solvers/blocked_mg.py, opt/pde_filter.py).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from topopt_in_petsc_tpu_torch.models.elements import (
    galerkin_octant_matrices,
)
from topopt_in_petsc_tpu_torch.ops.hex_operator import (
    apply_hex_operator,
    apply_hex_operator_octant,
    hex_operator_absrowsum,
    hex_operator_absrowsum_octant,
    hex_operator_diagonal,
    hex_operator_diagonal_octant,
    octant_split,
)
from topopt_in_petsc_tpu_torch.ops.nodal_hex import (
    make_helmholtz_apply,
    make_nodal_hex_apply,
)
from topopt_in_petsc_tpu_torch.solvers.cg import _dot, pcg_x
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


NODAL = (0, 1, 2)  # the spatial axes of a nodal (nx, ny, nz, dof) field


class OneBlock:
    """The solvers' hooks when the block is the whole grid (one device)."""

    # the block holds the cantilever's clamped wall (the x = 0 plane)
    wall = True
    # the `-operator_impl` values whose PDE filter applies the plain
    # operator (opt/pde_filter.py); float64 always does
    plain_filter_impls = ("xla",)

    def hierarchy(self, grid, nlvls: int):
        """The block's fine-to-coarse grids."""
        return grid.hierarchy(nlvls)

    def kernel_levels(self, nlvls: int, on: bool) -> List[bool]:
        """The levels that apply the kernel when the route has one (`on`)."""
        return [on] * nlvls

    def complete(self, v: torch.Tensor, axes=NODAL) -> torch.Tensor:
        """An operator's result, its partial sums completed (in place)."""
        return v

    def restrict(self, r: torch.Tensor, axes=NODAL) -> torch.Tensor:
        return restrict(r, axes)

    def max(self, v: torch.Tensor) -> torch.Tensor:
        """The maximum of a 0-d tensor over the blocks."""
        return v

    def dot(self, precise: bool, axes=NODAL) -> Callable:
        """The inner product of two vectors of the block's layout."""
        return lambda a, b: _dot(a, b, precise)


class PlainApply:
    """A level's operator in plain torch, with the kernel wrappers'
    interface (`prepare_coef`, `apply_prepared`): the hex operator with
    one element matrix, or with `octant` the octant-Galerkin form with
    its 8 octant matrices.  It computes in the dtype of the vector, with
    the coefficient and the matrices cast to it."""

    def __init__(self, KE: torch.Tensor, octant: bool = False):
        self.KE = KE
        self._op = apply_hex_operator_octant if octant else \
            apply_hex_operator

    def prepare_coef(self, coef: torch.Tensor) -> torch.Tensor:
        return coef

    def apply_prepared(self, u: torch.Tensor,
                       coef: torch.Tensor) -> torch.Tensor:
        return self._op(u, coef.to(u.dtype), self.KE.to(u.dtype))


class GeometricMultigrid:
    """V-cycle preconditioner for the masked hex operator, in the field
    dtype at every level, or bf16 (`precond_dtype`, the preconditioner's
    vectors only).

    grids: fine-to-coarse Grid hierarchy (length nlvls).
    KEs:   per-level (8 dof, 8 dof) element matrices (numpy).
    masks: per-level (nx, ny, nz, dof) 0/1 Dirichlet masks (numpy), or
           None (a pure Neumann problem: the Helmholtz filter).
    plain: plain torch operators instead of the kernels K3/K4.
    block: the hooks of the block the vectors hold (`OneBlock`); grids
           and masks are the block's.
    """

    def __init__(
        self,
        grids: Sequence,
        KEs: Sequence[np.ndarray],
        masks: Optional[Sequence[np.ndarray]],
        dof: int,
        *,
        device: torch.device,
        dtype=torch.float32,
        smooth_sweeps: int = 4,
        cheby_lower: float = 0.06,
        cheby_upper: float = 1.1,
        coarse_rtol: float = 1e-8,
        coarse_maxit: int = 30,
        precise_dots: bool = True,
        coarse_op: str = "rediscretize",
        precond_dtype=None,
        plain: bool = False,
        block: Optional[OneBlock] = None,
    ):
        if coarse_op not in ("rediscretize", "galerkin_octant"):
            raise ValueError(f"unknown coarse_op {coarse_op!r}")
        if not plain and dtype != torch.float32:
            raise ValueError(f"the kernels K3/K4 are f32-only, not {dtype}")
        self.dtype = dtype
        # the dtype of the V-cycle's vectors and Jacobi diagonals
        self.vdt = precond_dtype or dtype
        self.grids = tuple(grids)
        self.nlvls = len(self.grids)
        self.coarse_op = coarse_op
        fdt = dict(dtype=dtype, device=torch.device(device))
        self.KEs = [torch.as_tensor(np.asarray(k), **fdt) for k in KEs]
        # galerkin_octant: level l >= 1 is the projection of level l-1's
        # element matrix, sum_p w_p T_p^T KE_{l-1} T_p (exact Galerkin at
        # level 1, octant-averaged deeper)
        self.KEps = [None] * self.nlvls
        if coarse_op == "galerkin_octant":
            self.KEps[1:] = [
                torch.as_tensor(
                    galerkin_octant_matrices(np.asarray(KEs[l - 1]), dof),
                    **fdt)
                for l in range(1, self.nlvls)
            ]
        self.block = block = block or OneBlock()
        kernels = block.kernel_levels(self.nlvls, not plain)
        make = {1: make_helmholtz_apply, 3: make_nodal_hex_apply}[dof]
        self.level_applies = [
            PlainApply(self.KEps[l], octant=True) if self._octant(l)
            else make(g.nn, KEs[l]) if kernels[l]
            else PlainApply(self.KEs[l])
            for l, g in enumerate(self.grids)
        ]
        # per vector dtype: the per-level masks N and 1 - N
        self._masks = None
        if masks is not None:
            N = [torch.as_tensor(m, **fdt) for m in masks]
            self._masks = {
                dt: ([m.to(dt) for m in N], [(1.0 - m).to(dt) for m in N])
                for dt in {dtype, self.vdt}
            }
        self.smooth_sweeps = smooth_sweeps
        self.cheby_lower = cheby_lower
        self.cheby_upper = cheby_upper
        self.coarse_rtol = coarse_rtol
        self.coarse_maxit = coarse_maxit
        self.dot = block.dot(precise_dots)

    def _octant(self, level: int) -> bool:
        return self.KEps[level] is not None

    def apply(self, level: int, coef: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
        """A_l v = N (K_l (N v)) + (I - N) v (LinearElasticity.cc:530-538,
        applied matrix-free at every level), K_l completed across the
        blocks; `coef` is the level's prepared element coefficient
        (`setup`)."""
        ap = self.level_applies[level]
        complete = self.block.complete
        if self._masks is None:
            return complete(ap.apply_prepared(v.contiguous(), coef))
        masks, unmasks = self._masks[v.dtype]
        N = masks[level]
        Kv = complete(ap.apply_prepared(N * v, coef))
        return N * Kv + unmasks[level] * v

    def _level_coefs(self, scale_fine: torch.Tensor) -> List[torch.Tensor]:
        """Per-level coefficients from the fine element scale: level 0 the
        scale itself; a rediscretized level the 8-child average of the
        level above; an octant level the octant split of the level
        above's average (JAX `_level_coefs`)."""
        Es = [scale_fine.to(self.dtype)]
        for _ in range(1, self.nlvls):
            Es.append(coarsen_cell_field(Es[-1]))
        return [octant_split(Es[l - 1]) if self._octant(l) else Es[l]
                for l in range(self.nlvls)]

    def setup(self, scale_fine: torch.Tensor) -> List[dict]:
        """Per-level {coef, dinv, lmax} from the fine element scale: coef
        and lmax in the field dtype, dinv in the V-cycle's dtype.  lmax is
        the certain Gershgorin bound; masked rows are identity rows
        (diagonal 1, ratio 1).  The diagonal and the absolute row sums are
        completed across the blocks, the bound is their maximum."""
        block = self.block
        levels = []
        for l, E in enumerate(self._level_coefs(scale_fine)):
            nn = self.grids[l].nn
            if self._octant(l):
                d = hex_operator_diagonal_octant(E, self.KEps[l], nn)
                R = hex_operator_absrowsum_octant(E, self.KEps[l], nn)
            else:
                d = hex_operator_diagonal(E, self.KEs[l], nn)
                R = hex_operator_absrowsum(E, self.KEs[l], nn)
            d, R = block.complete(d), block.complete(R)
            mask = None
            if self._masks is not None:
                masks, unmasks = self._masks[self.dtype]
                mask = masks[l]
                d = mask * d + unmasks[l]
            levels.append({
                "coef": self.level_applies[l].prepare_coef(E),
                "dinv": (1.0 / d).to(self.vdt),
                "lmax": block.max(gershgorin_lambda_max(R, d, mask)),
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
                maxiter=self.coarse_maxit, flexible=False, dot=self.dot,
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
        rc = self._masked(level + 1, self.block.restrict(r))
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
