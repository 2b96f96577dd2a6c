"""Linear elasticity physics: cantilever BC/load, state solve, compliance.

Counterpart of the reference LinearElasticity class (LinearElasticity.cc)
on the paths of the JAX package's `models/elasticity.py`.  The route is
decided once, in the constructor (`solve_route`):

| `-operator_impl` | f32, rediscretize | f32, galerkin_octant | f64 |
| --- | --- | --- | --- |
| `auto`, `blocked` | resident (K1) | nodal, K4 (printed) | nodal, plain (printed) |
| `pallas` | nodal, K4 | nodal, K4 | nodal, plain (printed) |
| `xla` | nodal, plain | nodal, plain | nodal, plain |

- resident: the MG state solve runs in kernel K1's layout
  (solvers/blocked_mg.py), with the boundary conditions as index
  predicates;
- nodal: the solve runs on the nodal ``(nx, ny, nz, 3)`` field with stored
  Dirichlet masks and load, in a dof=3 `GeometricMultigrid`
  (solvers/multigrid.py) whose rediscretized levels apply kernel K4 (the
  `pallas` route) or the plain torch operator (the `xla` route, in the
  field dtype: the JAX package's XLA path), and whose octant-Galerkin
  coarse levels are plain torch on either.

The JAX package sends a float64 `blocked` or (on its CPU) `auto` request
to `xla` with the printed line; it runs `pallas` in float64 through its
kernel, which the port's f32-only K4 cannot, so the port sends it to
`xla` too.  A `galerkin_octant` request under `auto` or `blocked` goes to
the nodal `pallas` route, where the JAX package's CPU runs it; its TPU
resident solver drops the flag without a word (ROADMAP queue 3).

The compliance and its sensitivity come from kernel K2
(ops/quadform.py), or from the plain `element_quadratic_form` on the
`xla` route, as the JAX package's XLA objective does.

`-mg_dtype bfloat16` stores the V-cycle in bf16 on either layout (on the
resident one through K1's bf16-storage build, with `-mg_fine_post` f32
refinement steps); `mixed` (f32 fine level, bf16 coarse levels) exists on
the resident path only, and the nodal path runs it in the field dtype with
the JAX package's warning.  The outer Krylov is in the field dtype on both:
the resident solver's warm start, right-hand side and solution go through
its f32 operator `op32`.  (The JAX package's resident split solve converts
them through `ops[0]`, which under `-mg_dtype bfloat16` is the bf16
V-cycle operator, and fails with a dtype error: ROADMAP queue 3.)

The outer Krylov is flexible PCG or, under `-ksp_type fgmres`, FGMRES
(solvers/gmres.py).  The state solve has two forms: `solve_state`, one
eager call (the split driver), and `solve_start`, then `solve_advance` in
segments of predicated iterations while `solve_active`, with
`solve_close` after each FGMRES cycle (the fused step,
parallel/fused_step.py), the counterpart of the JAX package's
`_solve_impl`.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.models.elements import hex8_stiffness
from topopt_in_petsc_tpu_torch.ops.hex_operator import (
    element_quadratic_form,
)
from topopt_in_petsc_tpu_torch.ops.quadform import quadform
from topopt_in_petsc_tpu_torch.solvers.blocked_mg import BlockedElasticityMG
from topopt_in_petsc_tpu_torch.solvers.cg import (
    CGResult,
    accurate_sum,
    pcg,
    pcg_active,
    pcg_result,
    pcg_start,
    pcg_trips,
)
from topopt_in_petsc_tpu_torch.solvers.gmres import (
    fgmres,
    fgmres_active,
    fgmres_close,
    fgmres_result,
    fgmres_start,
    fgmres_trips,
)
from topopt_in_petsc_tpu_torch.solvers.multigrid import GeometricMultigrid


def solve_route(cfg) -> Tuple[str, Optional[str]]:
    """(route, printed line or None): "blocked" (resident, K1), "pallas"
    (nodal, K4) or "xla" (nodal, plain torch), by the table of the module
    docstring."""
    impl = cfg.operator_impl
    if cfg.dtype != "float32" and impl != "xla":
        what = ("the nodal kernel is" if impl == "pallas"
                else "blocked-resident solver is")
        return "xla", (f"# operator_impl '{impl}': {what} float32-only; "
                       f"using 'xla' for dtype={cfg.dtype}")
    if impl in ("auto", "blocked"):
        if cfg.coarse_op != "rediscretize":
            return "pallas", (
                f"# operator_impl '{impl}': blocked-resident solver has no "
                f"coarse_op '{cfg.coarse_op}'; using 'pallas'")
        return "blocked", None
    return impl, None


# the resident solver's `mg_dtype` of each resolved -mg_dtype mode
# (`TopOptConfig.resolve_mg_mode`)
RESIDENT_MG_DTYPE = {"same": None, "bfloat16": torch.bfloat16,
                     "mixed": "mixed"}


def nodal_precond_dtype(mode: str, route: str, warn: bool = True):
    """The nodal V-cycle's dtype (`GeometricMultigrid`'s precond_dtype) of
    the resolved -mg_dtype `mode`: bf16 for "bfloat16", else the field
    dtype (None).  "mixed" has no nodal form: with `warn` it prints the
    JAX package's warning and runs the field dtype."""
    if mode == "mixed" and warn:
        print(
            "warning: -mg_dtype mixed needs the blocked solver "
            f"(operator_impl={route}); running a pure-f32 "
            "V-cycle instead — the memory lever is OFF on this path",
            file=sys.stderr,
        )
    return torch.bfloat16 if mode == "bfloat16" else None


def nodal_krylov(cfg):
    """(solve, its own arguments) of the nodal state solve: FGMRES(restart)
    under -ksp_type fgmres, else flexible PCG (whatever -ksp_type, as the
    JAX package's nodal solve)."""
    if cfg.ksp_type == "fgmres":
        return fgmres, dict(restart=cfg.ksp_gmres_restart)
    return pcg, dict(flexible=True)


def build_cantilever_bc(grid: Grid, dtype=np.float64):
    """Dirichlet mask N and load RHS for the reference cantilever problem
    (LinearElasticity.cc:143-171), as nodal (nx, ny, nz, 3) numpy arrays:

      - wall at x = xcmin fully clamped (all 3 dofs zero),
      - line load F_z = -0.001 along the edge (x = xcmax, z = zcmin),
        halved at the two corners (y = ycmin and y = ycmax).

    The nodal solve stores these fields; the resident solver builds the
    same sets from index predicates (ops/blocked_hex.py).
    """
    nx, ny, nz = grid.nn
    N = np.ones((nx, ny, nz, 3), dtype=dtype)
    N[0, :, :, :] = 0.0  # clamped wall

    RHS = np.zeros((nx, ny, nz, 3), dtype=dtype)
    load = -0.001
    RHS[nx - 1, :, 0, 2] = load
    RHS[nx - 1, 0, 0, 2] = load / 2.0
    RHS[nx - 1, ny - 1, 0, 2] = load / 2.0
    RHS *= N
    return N, RHS


class PhysicsResult(NamedTuple):
    u: torch.Tensor  # state field (nx, ny, nz, 3)
    iters: int  # Krylov iterations
    relres: torch.Tensor  # final relative residual, 0-d
    fx: torch.Tensor  # compliance  U^T K U, 0-d
    gx: torch.Tensor  # (m,) constraints; gx[0] = mean(xPhys) - volfrac
    dfdx: torch.Tensor  # (ex, ey, ez) compliance sensitivity
    dgdx: torch.Tensor  # (m, ex, ey, ez) constraint sensitivities


class LinearElasticity:
    """Cantilever elasticity on the structured grid (LinearElasticity.cc)."""

    def __init__(self, cfg, grid: Optional[Grid] = None, *,
                 device: torch.device):
        self.cfg = cfg
        self.grid = grid or Grid.from_config(cfg)
        self.device = torch.device(device)
        self.dtype = cfg.torch_dtype
        self.KE = hex8_stiffness(*self.grid.h, cfg.nu)  # f64 numpy
        self.route, note = solve_route(cfg)
        if note:
            print(note)
        # per-level rediscretized element matrices (coarse nodes coincide
        # with fine nodes at even indices)
        grids = self.grid.hierarchy(cfg.nlvls)
        KEs = [hex8_stiffness(*g.h, cfg.nu) for g in grids]
        mg_args = dict(
            device=self.device,
            smooth_sweeps=cfg.smooth_sweeps,
            cheby_lower=cfg.resolve_cheby_lower(cfg.ndof),
            cheby_upper=cfg.cheby_upper,
            coarse_rtol=cfg.coarse_rtol,
            coarse_maxit=cfg.coarse_maxit,
            precise_dots=cfg.precise_dots,
        )
        mode = cfg.resolve_mg_mode(cfg.ndof)
        self.solver = self.mg = None
        if self.route == "blocked":
            self.solver = BlockedElasticityMG(
                grids, KEs, **mg_args, mg_dtype=RESIDENT_MG_DTYPE[mode],
                fine_post_smooth=cfg.mg_fine_post,
            )
            # the resident load vector, f32 like every outer vector
            self._b = self.solver.op32.cantilever_rhs(dtype=torch.float32)
            return
        precond_dtype = nodal_precond_dtype(mode, self.route)
        # nodal path: per-level masks by node subsampling (coarse nodes
        # coincide with fine nodes at even indices)
        N, RHS = build_cantilever_bc(self.grid)
        self.RHS = torch.as_tensor(RHS, dtype=self.dtype, device=self.device)
        masks = [N[:: 2**l, :: 2**l, :: 2**l] for l in range(cfg.nlvls)]
        self.mg = GeometricMultigrid(
            grids, KEs, masks, dof=3, dtype=self.dtype,
            coarse_op=cfg.coarse_op, plain=self.route == "xla",
            precond_dtype=precond_dtype, **mg_args,
        )
        if self.route == "xla":
            self._KEt = torch.as_tensor(self.KE, dtype=self.dtype,
                                        device=self.device)

    # -- SIMP interpolation (LinearElasticity.cc:519) ------------------ #

    def simp(self, xPhys: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return cfg.Emin + xPhys**cfg.penal * (cfg.Emax - cfg.Emin)

    # -- state solve --------------------------------------------------- #

    def solve_state(self, xPhys: torch.Tensor,
                    u0: Optional[torch.Tensor] = None) -> CGResult:
        """SolveState (LinearElasticity.cc:182-223): set the element scale,
        rebuild the MG setup, solve from the warm start u0 (nodal); the
        returned solution is nodal (nx, ny, nz, 3)."""
        cfg = self.cfg
        E = self.simp(xPhys.to(self.dtype))
        if self.mg is not None:
            return self._solve_nodal(E, u0)
        op0 = self.solver.op32
        if u0 is None:
            x0 = torch.zeros_like(self._b)
        else:
            x0 = op0.mask0(op0.to_blocked(u0))
        res = self.solver.solve(
            E, self._b, x0, rtol=cfg.ksp_rtol, maxiter=cfg.ksp_maxit,
            ksp_type=cfg.ksp_type, gmres_restart=cfg.ksp_gmres_restart,
        )
        return CGResult(
            x=op0.from_blocked(res.x, self.dtype),
            iters=res.iters,
            relres=res.relres,
        )

    @property
    def _fgmres(self) -> bool:
        return self.cfg.ksp_type == "fgmres"

    def solve_start(self, xPhys: torch.Tensor, u0: torch.Tensor):
        """The predicated form of `solve_state`: (MG levels, Krylov carry
        before the first iteration) from the nodal warm start u0.  The
        carry (`PCGState`, or `FGMRESState` under FGMRES) lives in the
        solver's layout (`solution` converts)."""
        cfg = self.cfg
        E = self.simp(xPhys.to(self.dtype))
        if self.mg is None:
            op0 = self.solver.op32
            return self.solver.start(
                E, self._b, op0.mask0(op0.to_blocked(u0)),
                rtol=cfg.ksp_rtol, ksp_type=cfg.ksp_type,
                gmres_restart=cfg.ksp_gmres_restart)
        levels = self.mg.setup(E)
        A = self._nodal_A(levels)
        if self._fgmres:
            return levels, fgmres_start(
                A, self.RHS, u0.contiguous(), rtol=cfg.ksp_rtol,
                restart=cfg.ksp_gmres_restart,
                precise_dots=cfg.precise_dots)
        return levels, pcg_start(
            A, self.RHS, u0.contiguous(),
            self.mg.preconditioner(levels, predicated=True),
            precise_dots=cfg.precise_dots,
        )

    def solve_advance(self, levels: list, state, n: int):
        """n predicated iterations of the state solve."""
        cfg = self.cfg
        if self.mg is None:
            return self.solver.advance(
                levels, state, n, rtol=cfg.ksp_rtol, maxiter=cfg.ksp_maxit,
                ksp_type=cfg.ksp_type,
            )
        A = self._nodal_A(levels)
        M = self.mg.preconditioner(levels, predicated=True)
        if self._fgmres:
            return fgmres_trips(A, state, M, n, maxiter=cfg.ksp_maxit,
                                precise_dots=cfg.precise_dots)
        return pcg_trips(
            A, state, M, n, rtol=cfg.ksp_rtol, maxiter=cfg.ksp_maxit,
            flexible=True, precise_dots=cfg.precise_dots,
        )

    def solve_active(self, state) -> torch.Tensor:
        """0-d device flag: does the solve (the FGMRES cycle) take another
        iteration?"""
        cfg = self.cfg
        if self._fgmres:
            return fgmres_active(state, maxiter=cfg.ksp_maxit)
        return pcg_active(state, rtol=cfg.ksp_rtol, maxiter=cfg.ksp_maxit)

    def solve_close(self, levels: list, state):
        """The end of an FGMRES cycle: (state, 0-d flag "another
        cycle")."""
        cfg = self.cfg
        if self.mg is None:
            return self.solver.close(levels, state, self._b,
                                     maxiter=cfg.ksp_maxit)
        return fgmres_close(self._nodal_A(levels), self.RHS, state,
                            maxiter=cfg.ksp_maxit,
                            precise_dots=cfg.precise_dots)

    def solve_result(self, state) -> CGResult:
        """(x, iterations, relative residual) of a finished carry."""
        return fgmres_result(state) if self._fgmres else pcg_result(state)

    def solution(self, x: torch.Tensor) -> torch.Tensor:
        """The carry's x as the nodal (nx, ny, nz, 3) field."""
        if self.mg is not None:
            return x
        return self.solver.op32.from_blocked(x, self.dtype)

    def _nodal_A(self, levels):
        return lambda v: self.mg.apply(0, levels[0]["coef"], v)

    def _solve_nodal(self, E: torch.Tensor,
                     u0: Optional[torch.Tensor]) -> CGResult:
        """The nodal solve: flexible PCG or FGMRES from the unmasked warm
        start, with A = N K N + (I - N) and one V-cycle as the
        preconditioner."""
        cfg = self.cfg
        levels = self.mg.setup(E)
        x0 = torch.zeros_like(self.RHS) if u0 is None else u0.contiguous()
        solve, extra = nodal_krylov(cfg)
        return solve(
            self._nodal_A(levels), self.RHS, x0,
            self.mg.preconditioner(levels),
            rtol=cfg.ksp_rtol, maxiter=cfg.ksp_maxit,
            precise_dots=cfg.precise_dots, **extra,
        )

    # -- objective / constraints / sensitivities ----------------------- #

    def _objective_parts(self, xPhys: torch.Tensor, u: torch.Tensor):
        cfg = self.cfg
        if self.route == "xla":
            uKu = element_quadratic_form(u, self._KEt)
        else:
            uKu = quadform(u, self.KE)  # (ex, ey, ez)
        E = self.simp(xPhys)
        fx = accurate_sum(E * uKu, cfg.precise_dots)
        nelem = xPhys.numel()
        gx0 = accurate_sum(xPhys, cfg.precise_dots) / nelem - cfg.volfrac
        dfdx = (
            -cfg.penal * xPhys ** (cfg.penal - 1.0) * (cfg.Emax - cfg.Emin)
        ) * uKu
        dgdx = torch.full(
            (cfg.m,) + tuple(xPhys.shape), 1.0 / nelem, dtype=self.dtype,
            device=xPhys.device,
        )
        gx = torch.zeros((cfg.m,), dtype=self.dtype, device=xPhys.device)
        gx[0] = gx0
        return fx.to(self.dtype), gx, dfdx, dgdx

    def compute_objective_constraints_sensitivities(
        self, xPhys: torch.Tensor, u0: Optional[torch.Tensor] = None
    ) -> PhysicsResult:
        """ComputeObjectiveConstraintsSensitivities
        (LinearElasticity.cc:363-445): the state solve, then the objective
        from its solution."""
        res = self.solve_state(xPhys, u0)
        fx, gx, dfdx, dgdx = self._objective_parts(
            xPhys.to(self.dtype), res.x
        )
        return PhysicsResult(
            u=res.x, iters=res.iters, relres=res.relres,
            fx=fx, gx=gx, dfdx=dfdx, dgdx=dgdx,
        )
