"""Helmholtz PDE filter: (-R^2 lap + I) u_tilde = T x, xTilde = T^T u_tilde.

Counterpart of the reference PDEFilt class (PDEFilter.{h,cc}) on the JAX
package's `opt/pde_filter.py`.  R = rmin / (2 sqrt(3)) converts the
convolution radius to the Helmholtz length scale (PDEFilter.cc:30).  The
operator is the matrix-free hex operator with dof=1 and a unit element
scale, kernel K3 at every MG level (ops/nodal_hex.py), or under
`-operator_impl xla` and `-dtype float64` the plain torch operator in the
field dtype (the JAX package's XLA filter), solved by flexible CG with a
geometric-multigrid V-cycle.  The operator does not depend on
the design, so the MG setup runs once, at construction.

Every solve warm-starts from the previous solve's solution, whatever its
right-hand side was (KSPSetInitialGuessNonzero, PDEFilter.cc:285): the
design, then dfdx, then each dgdx row, in the driver's order.

The filter map is self-adjoint: Gradients() == FilterProject()
(PDEFilter.cc:218).

A solve runs either as one eager `pcg` call (the split driver) or in the
predicated form, `start`, `advance` in segments and `finish` (the fused
step); the warm start is one buffer, updated in place.

Under `-mesh_shape` each rank filters its element block through the hooks
of its `parallel/spmd.py::MeshBlock` (the JAX package's
`parallel/spmd_pde_filter.py`): the multigrid on the rank's blocks with
min(pde_nlvls, nlvls) levels, T's scatter completed across the blocks,
dots over the owned nodes, K3 on the levels of the JAX engine's rule, and
no smoke solve.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from topopt_in_petsc_tpu_torch.models.elements import (
    helmholtz_element_matrices,
)
from topopt_in_petsc_tpu_torch.ops.hex_operator import (
    gather_element_dofs,
    scatter_element_dofs,
)
from topopt_in_petsc_tpu_torch.opt.filters import (
    smooth_projection,
    smooth_projection_chainrule,
)
from topopt_in_petsc_tpu_torch.solvers.cg import (
    PCGState,
    pcg,
    pcg_active,
    pcg_start,
    pcg_trips,
)
from topopt_in_petsc_tpu_torch.solvers.multigrid import (
    GeometricMultigrid,
    OneBlock,
)


class PDEFilter:
    def __init__(self, cfg, grid, *, device: torch.device,
                 smoke: bool = True, block: Optional[OneBlock] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = cfg.torch_dtype
        self.R = cfg.rmin / (2.0 * math.sqrt(3.0))
        self.block = block = block or OneBlock()

        # cfg.validate() checked that the grid halves pde_nlvls - 1 times
        grids = block.hierarchy(grid, cfg.pde_nlvls)
        # the block's grid: the nodes and elements of the filtered fields
        self.grid = grids[0]
        KFs = [helmholtz_element_matrices(*g.h, self.R)[0]
               for g in grid.hierarchy(len(grids))]
        self.mg = GeometricMultigrid(
            grids,
            KFs,
            None,  # pure Neumann: no Dirichlet mask
            dof=1,
            device=self.device,
            dtype=self.dtype,
            plain=(cfg.operator_impl in block.plain_filter_impls
                   or cfg.dtype != "float32"),
            smooth_sweeps=max(2, cfg.smooth_sweeps // 2),
            coarse_rtol=1e-8,
            coarse_maxit=10,
            precise_dots=cfg.precise_dots,
            block=block,
        )
        # design-independent operator: one MG setup with unit scale
        self._levels = self.mg.setup(
            torch.ones(self.grid.ne, dtype=self.dtype, device=self.device)
        )
        self.elem_volume = grid.elem_volume

        # warm-start state (KSPSetInitialGuessNonzero, PDEFilter.cc:285)
        nx, ny, nz = self.grid.nn
        self._u = torch.zeros((nx, ny, nz, 1), dtype=self.dtype,
                              device=self.device)

        if not smoke:
            # the JAX package's single-program filter (its SPMD engine,
            # which `-fused 1 -filter 2` runs) has no smoke solve
            return
        # constructor smoke test, like PDEFilter.cc:175-187; drawn on the
        # CPU so every device gets the same numbers
        gen = torch.Generator().manual_seed(0)
        test = torch.rand(self.grid.ne, generator=gen, dtype=self.dtype)
        self._project_core_host(test.to(self.device))
        print("Done setting up the PDEFilter")

    def set_warm_start(self, u: np.ndarray) -> None:
        """Replace the warm start by a nodal (nx, ny, nz, 1) field, e.g.
        the JAX package's filter state `PDEFilter._u`, to carry one run's
        solve sequence into another."""
        self._u.copy_(torch.as_tensor(
            np.asarray(u), dtype=self.dtype
        ).reshape(self._u.shape))

    # -- T and T^T ------------------------------------------------------ #

    def _T_apply(self, x: torch.Tensor) -> torch.Tensor:
        """RHS = elemVol * T x: each element spreads x_e/8 to its corners
        (PDEFilter.cc:198-202 MatMult(T,...) + VecScale(elemVol)),
        completed across the blocks."""
        fe = (x[..., None] * 0.125).expand(*x.shape, 8)
        return self.elem_volume * self.block.complete(
            scatter_element_dofs(fe, self.grid.nn))

    def _Tt_apply(self, u: torch.Tensor) -> torch.Tensor:
        """xTilde = T^T u: mean of the 8 corner node values
        (PDEFilter.cc:210 MatMultTranspose)."""
        return gather_element_dofs(u).mean(dim=-1)

    # -- solve ----------------------------------------------------------- #

    def _A(self, v):
        return self.mg.apply(0, self._levels[0]["coef"], v)

    def _solve(self, x, u0):
        cfg = self.cfg
        res = pcg(
            self._A, self._T_apply(x), u0,
            self.mg.preconditioner(self._levels),
            rtol=cfg.pde_rtol,
            maxiter=cfg.pde_maxit,
            flexible=True,
            dot=self.mg.dot,
        )
        return res.x, self._Tt_apply(res.x), res.iters, res.relres

    def _project_core_host(self, x):
        """One filter solve from the kept warm start, which it replaces."""
        u, xt, iters, relres = self._solve(x.to(self.dtype), self._u)
        self._u.copy_(u)
        return xt, iters, float(relres)

    # -- the predicated form (parallel/fused_step.py) -------------------- #

    def start(self, x: torch.Tensor) -> PCGState:
        """The Krylov carry of the solve for design-shaped x, from the kept
        warm start."""
        return pcg_start(
            self._A, self._T_apply(x.to(self.dtype)), self._u,
            self.mg.preconditioner(self._levels, predicated=True),
            dot=self.mg.dot,
        )

    def advance(self, state: PCGState, n: int) -> PCGState:
        cfg = self.cfg
        return pcg_trips(
            self._A, state,
            self.mg.preconditioner(self._levels, predicated=True), n,
            rtol=cfg.pde_rtol, maxiter=cfg.pde_maxit, flexible=True,
            dot=self.mg.dot,
        )

    def active(self, state: PCGState) -> torch.Tensor:
        return pcg_active(state, rtol=self.cfg.pde_rtol,
                          maxiter=self.cfg.pde_maxit)

    def finish(self, state: PCGState) -> torch.Tensor:
        """Keep the solution as the next warm start; returns T^T u."""
        self._u.copy_(state.x)
        return self._Tt_apply(state.x)

    # -- public API of filter type 2 ------------------------------------- #

    def filter_project(self, x):
        xt, _, _ = self._project_core_host(x)
        return xt

    def filter_project_with_projection(self, x, projection, beta, eta):
        xt, _, _ = self._project_core_host(x)
        # bound-violation clip (Filter.cc:76-101)
        viol = float(torch.maximum(torch.max(-xt), torch.max(xt - 1.0)))
        if viol > 1e-4:
            print(
                "BOUND VIOLATION IN PDEFILTER - INCREASE RMIN OR MESH "
                f"RESOLUTION: xPhys = {viol:f}"
            )
        xt = torch.clamp(xt, 0.0, 1.0)
        if projection:
            xPhys = smooth_projection(xt, beta, eta)
        else:
            xPhys = xt
        return xt, xPhys

    def gradients(self, s):
        """Self-adjoint: Gradients == FilterProject (PDEFilter.cc:218)."""
        return self.filter_project(s)

    def gradients_with_projection(self, x, xTilde, dfdx, dgdx, projection,
                                  beta, eta):
        if projection:
            dproj = smooth_projection_chainrule(xTilde, beta, eta)
            dfdx = dfdx * dproj
            dgdx = dgdx * dproj[None]
        dfdx = self.filter_project(dfdx)
        dgdx = torch.stack(
            [self.filter_project(dgdx[j]) for j in range(dgdx.shape[0])]
        )
        return dfdx, dgdx
