"""The physics and the optimization iteration of `-mesh_shape`, on this
rank's block: the JAX package's `parallel/spmd_model.py`
(`SpmdElasticity`, `make_spmd_fused_step`).

`SpmdElasticity` solves the cantilever on the rank grid by the route of
the single-device port (`models/elasticity.py::solve_route`), with the
single-device solvers on the rank's block through its `MeshBlock` hooks
(parallel/spmd.py):

- `blocked` (`auto` and `blocked` in f32): the resident solve
  (solvers/blocked_mg.py), kernel K1 on the local block;
- `pallas`: the nodal `GeometricMultigrid` (solvers/multigrid.py) with
  kernel K4 at the fine level and, when the fine block's shortest side is
  at most 129 nodes, on every coarse level of at least 17 (the JAX
  package's rule);
- `xla` (and float64 on any route): the same multigrid on the plain
  operators in the field dtype.

The single-device solvers' options carry over unchanged:
- `-mg_dtype` (resolved on the shard's own dof, as the JAX engine does)
  and `-mg_fine_post`: on the resident route the bf16 levels run K1's
  bf16-storage build (K1-bf16) with the f32 `op32` for the outer Krylov,
  and their planes are exchanged and added in bf16, as the JAX engine's
  `ppermute` of the level's array; the nodal route runs `bfloat16` and
  warns for `mixed`, as on one device;
- `-coarse_op galerkin_octant`, on the nodal route where `solve_route`
  sends it: the octant levels are plain torch, K4 runs at the fine level;
- `-ksp_type fgmres`: solvers/gmres.py with the mesh's dot, modified
  Gram-Schmidt as the reference computes it (one reduction per
  projection).

Two routes of the JAX engine are not copied (ROADMAP queue 3): under
`-ksp_type fgmres` it runs flexible CG, and its nodal V-cycle ignores
`-mg_dtype`.

The objective takes the local compliance from kernel K2 (the plain
`element_quadratic_form` on `xla`) and sums it over the ranks.

`SpmdStep` is one optimization iteration on the local blocks, run eagerly
(gloo's collectives run on the host): the state solve from the last
solution, fx and the sensitivities, fscale at iteration 1, the projection's
and the filter's chain rule, MMA with the reduction hooks, the design
change, the design filter and projection, MND.  Iterations 1 and 2 take
fresh asymptotes, as the JAX package's first-iteration and steady
variants do.  The density and sensitivity filters convolve the block
widened by ghost layers (`ghost_fill_elem`), directly or by FFT above
`FFT_TAP_THRESHOLD` taps; `-filter 2` is opt/pde_filter.py on the block.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.models.elasticity import (
    RESIDENT_MG_DTYPE,
    nodal_krylov,
    nodal_precond_dtype,
    solve_route,
)
from topopt_in_petsc_tpu_torch.models.elements import hex8_stiffness
from topopt_in_petsc_tpu_torch.ops.conv_filter import (
    FFT_TAP_THRESHOLD,
    make_fft_conv,
)
from topopt_in_petsc_tpu_torch.ops.blocked_hex import mask0
from topopt_in_petsc_tpu_torch.ops.hex_operator import (
    element_quadratic_form,
)
from topopt_in_petsc_tpu_torch.ops.quadform import quadform
from topopt_in_petsc_tpu_torch.opt.filters import (
    build_filter_kernel,
    filter_stencil_halfwidth,
    smooth_projection,
    smooth_projection_chainrule,
)
from topopt_in_petsc_tpu_torch.opt.mma import MMA
from topopt_in_petsc_tpu_torch.opt.pde_filter import PDEFilter
from topopt_in_petsc_tpu_torch.parallel.comm import (
    allreduce_max,
    allreduce_sum,
)
from topopt_in_petsc_tpu_torch.parallel.decomp import BlockDecomp
from topopt_in_petsc_tpu_torch.parallel.mesh import RankMesh
from topopt_in_petsc_tpu_torch.parallel.spmd import (
    MeshBlock,
    ghost_fill_elem,
)
from topopt_in_petsc_tpu_torch.solvers.blocked_mg import BlockedElasticityMG
from topopt_in_petsc_tpu_torch.solvers.cg import accurate_sum
from topopt_in_petsc_tpu_torch.solvers.multigrid import GeometricMultigrid


class SpmdElasticity:
    """The cantilever's state solve and objective on this rank's block."""

    def __init__(self, cfg, mesh: RankMesh, decomp: BlockDecomp,
                 block: MeshBlock, log: Callable = print):
        self.cfg = cfg
        self.mesh = mesh
        self.decomp = decomp
        self.block = block
        self.dtype = cfg.torch_dtype
        self.nelem = decomp.grid.nelem
        self.route, note = solve_route(cfg)
        if note:
            log(note)
        KEs = [hex8_stiffness(*g.h, cfg.nu)
               for g in decomp.grid.hierarchy(cfg.nlvls)]
        self.KE = KEs[0]
        grids = block.hierarchy(decomp.grid, cfg.nlvls)
        local_ndof = 3 * int(np.prod(decomp.local_nn(0)))
        mg_args = dict(
            device=mesh.device, smooth_sweeps=cfg.smooth_sweeps,
            cheby_lower=cfg.resolve_cheby_lower(local_ndof),
            cheby_upper=cfg.cheby_upper, coarse_rtol=cfg.coarse_rtol,
            coarse_maxit=cfg.coarse_maxit, precise_dots=cfg.precise_dots,
            block=block,
        )
        # the V-cycle's storage by the shard's own dof, as the JAX engine
        # resolves it
        mode = cfg.resolve_mg_mode(local_ndof)
        self.bmg = self.mg = None
        dev = mesh.device
        rhs = self._nodal_rhs()
        if self.route == "blocked":
            self.bmg = BlockedElasticityMG(
                grids, KEs, **mg_args, mg_dtype=RESIDENT_MG_DTYPE[mode],
                fine_post_smooth=cfg.mg_fine_post)
            self._b = self.bmg.op32.to_blocked(rhs)
            return
        self.RHS = rhs
        # the wall's Dirichlet mask, on the ranks that hold it
        masks = None
        if block.wall:
            masks = [np.ones((*g.nn, 3)) for g in grids]
            for m in masks:
                m[0] = 0.0
        self.mg = GeometricMultigrid(
            grids, KEs, masks, dof=3, dtype=self.dtype,
            coarse_op=cfg.coarse_op, plain=self.route == "xla",
            precond_dtype=nodal_precond_dtype(mode, self.route,
                                              warn=mesh.primary),
            **mg_args)
        if self.route == "xla":
            self._KEt = torch.as_tensor(self.KE, dtype=self.dtype,
                                        device=dev)

    def _nodal_rhs(self, load: float = -0.001) -> torch.Tensor:
        """This block of the nodal load (models/elasticity.py
        `build_cantilever_bc`): F_z on the global edge (x = nx-1, z = 0),
        halved at the global y ends."""
        nx, ny, nz = self.decomp.local_nn(0)
        rhs = torch.zeros((nx, ny, nz, 3), dtype=self.dtype,
                          device=self.mesh.device)
        cx, _, cz = self.mesh.coords
        if cx == self.mesh.shape[0] - 1 and cz == 0:
            y = np.arange(ny) + self.decomp.origin(self.mesh.coords)[1]
            w = np.where((y == 0) | (y == self.decomp.grid.nn[1] - 1), 0.5,
                         1.0)
            rhs[nx - 1, :, 0, 2] = torch.as_tensor(
                load * w, dtype=self.dtype, device=self.mesh.device)
        return rhs

    def simp(self, xPhys: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return cfg.Emin + xPhys**cfg.penal * (cfg.Emax - cfg.Emin)

    def solve(self, xPhys: torch.Tensor, u0: torch.Tensor):
        """(u, iterations, relative residual) of the state solve from the
        nodal warm start u0; u is this block's nodal field."""
        cfg = self.cfg
        E = self.simp(xPhys.to(self.dtype))
        if self.bmg is not None:
            op = self.bmg.op32
            x0 = op.to_blocked(u0)
            res = self.bmg.solve(E, self._b,
                                 mask0(x0) if self.block.wall else x0,
                                 rtol=cfg.ksp_rtol, maxiter=cfg.ksp_maxit,
                                 ksp_type=cfg.ksp_type,
                                 gmres_restart=cfg.ksp_gmres_restart)
            return op.from_blocked(res.x, self.dtype), res.iters, res.relres
        levels = self.mg.setup(E)
        solve, extra = nodal_krylov(cfg)
        res = solve(
            lambda v: self.mg.apply(0, levels[0]["coef"], v), self.RHS,
            u0.contiguous(), self.mg.preconditioner(levels),
            rtol=cfg.ksp_rtol, maxiter=cfg.ksp_maxit, dot=self.mg.dot,
            **extra,
        )
        return res.x, res.iters, res.relres

    def objective(self, xPhys: torch.Tensor, u: torch.Tensor):
        """(fx, gx, dfdx, dgdx) from the solved block: fx and the volume
        summed over the ranks, the sensitivities local."""
        cfg, mesh = self.cfg, self.mesh
        if self.route == "xla":
            uKu = element_quadratic_form(u, self._KEt)
        else:
            uKu = quadform(u, self.KE)
        E = self.simp(xPhys)
        fx = allreduce_sum(mesh, accurate_sum(E * uKu, cfg.precise_dots))
        vol = allreduce_sum(mesh, accurate_sum(xPhys, cfg.precise_dots))
        gx = torch.zeros((cfg.m,), dtype=self.dtype, device=mesh.device)
        gx[0] = vol / self.nelem - cfg.volfrac
        dfdx = (-cfg.penal * xPhys ** (cfg.penal - 1.0)
                * (cfg.Emax - cfg.Emin)) * uKu
        dgdx = torch.full((cfg.m, *xPhys.shape), 1.0 / self.nelem,
                          dtype=self.dtype, device=mesh.device)
        return fx.to(self.dtype), gx, dfdx, dgdx


class _ConvFilter:
    """The density filter's convolution H on the block: the block widened
    by `s` ghost layers, then a valid convolution with the hat kernel
    (direct, or FFT above `FFT_TAP_THRESHOLD` taps)."""

    def __init__(self, cfg, mesh: RankMesh, decomp: BlockDecomp, dtype):
        grid = decomp.grid
        self.mesh = mesh
        self.s = s = filter_stencil_halfwidth(cfg.rmin, grid.h, grid.nn)
        ne = decomp.local_ne(0)
        if any(s > e for e in ne):
            raise ValueError(
                f"filter stencil halfwidth {s} exceeds local block {ne}; "
                f"use the PDE filter or a larger block")
        k = build_filter_kernel(cfg.rmin, grid.h, s)
        self._fft = None
        if (2 * s + 1) ** 3 > FFT_TAP_THRESHOLD:
            self._fft = make_fft_conv(tuple(e + 2 * s for e in ne), k,
                                      dtype, mesh.device)
        else:
            self.kernel = torch.as_tensor(k, dtype=dtype,
                                          device=mesh.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        s = self.s
        g = ghost_fill_elem(self.mesh, x, s)
        if self._fft is None:
            return F.conv3d(g[None, None], self.kernel[None, None])[0, 0]
        n = x.shape
        return self._fft(g)[s:s + n[0], s:s + n[1], s:s + n[2]]


@dataclasses.dataclass
class SpmdState:
    """This rank's blocks of the design fields and the state field, with
    the objective scale and the projection's beta (host floats)."""

    x: torch.Tensor
    xTilde: torch.Tensor
    xPhys: torch.Tensor
    u: torch.Tensor
    fscale: float
    beta: float


class SpmdStep:
    """One optimization iteration on this rank's blocks (module
    docstring); `step(itr)` updates `state` and returns the iteration's
    numbers as host values, the same on every rank."""

    def __init__(self, cfg, mesh: RankMesh, log: Callable = print):
        self.cfg = cfg
        self.mesh = mesh
        self.grid = grid = Grid.from_config(cfg)
        self.decomp = decomp = BlockDecomp(grid, mesh.shape, cfg.nlvls)
        self.dtype = dt = cfg.torch_dtype
        block = MeshBlock(mesh, decomp)
        self.physics = SpmdElasticity(cfg, mesh, decomp, block, log)
        self.conv = self.Hs = self.pdef = None
        if cfg.filter in (0, 1):
            self.conv = _ConvFilter(cfg, mesh, decomp, dt)
            self.Hs = self.conv(torch.ones(decomp.local_ne(0), dtype=dt,
                                           device=mesh.device))
        elif cfg.filter == 2:
            self.pdef = PDEFilter(cfg, grid, device=mesh.device,
                                  smoke=False, block=block)
        precise = cfg.precise_dots
        sdt = torch.float64 if precise else dt
        self.mma = MMA(
            grid.nelem, cfg.m, decomp.local_ne(0), device=mesh.device,
            dtype=dt, precise_dots=precise,
            reduce_sum=lambda v: allreduce_sum(mesh, torch.sum(v, dtype=sdt)),
            reduce_max=lambda v: allreduce_max(mesh, torch.max(v)),
            reduce_matrix=lambda H: allreduce_sum(mesh, H),
        )
        x0 = torch.full(decomp.local_ne(0), cfg.volfrac, dtype=dt,
                        device=mesh.device)
        self.state = SpmdState(
            x=x0, xTilde=x0, xPhys=self._project(x0, cfg.beta), u=torch.zeros(
                (*decomp.local_nn(0), 3), dtype=dt, device=mesh.device),
            fscale=1.0, beta=cfg.beta)
        # the last design filter's bound violation (-filter 2 only)
        self.pde_viol = 0.0

    def _project(self, xTilde: torch.Tensor, beta: float) -> torch.Tensor:
        if self.cfg.projectionFilter:
            return smooth_projection(xTilde, beta, self.cfg.eta)
        return xTilde

    def filter_project(self, x: torch.Tensor):
        """(xTilde, xPhys) of the design block x with the state's beta;
        under `-filter 2` it advances the PDE warm start and sets
        `pde_viol`."""
        if self.cfg.filter == 1:
            xTilde = self.conv(x) / self.Hs
        elif self.cfg.filter == 2:
            xt = self.pdef.filter_project(x)
            self.pde_viol = float(allreduce_max(self.mesh, torch.maximum(
                torch.max(-xt), torch.max(xt - 1.0))))
            xTilde = torch.clamp(xt, 0.0, 1.0)
        else:
            xTilde = x
        return xTilde, self._project(xTilde, self.state.beta)

    def _gradients(self, x, xTilde, dfdx, dgdx):
        """The projection's and the filter's chain rule (Filter.cc:120-204;
        `-filter 2` is self-adjoint, PDEFilter.cc:218)."""
        cfg = self.cfg
        if cfg.projectionFilter:
            dproj = smooth_projection_chainrule(xTilde, self.state.beta,
                                                cfg.eta)
            dfdx = dfdx * dproj
            dgdx = dgdx * dproj[None]
        if cfg.filter == 0:
            dfdx = self.conv(dfdx * x) / self.Hs / x
        elif cfg.filter == 1:
            dfdx = self.conv(dfdx / self.Hs)
            dgdx = torch.stack([self.conv(dgdx[j] / self.Hs)
                                for j in range(cfg.m)])
        elif cfg.filter == 2:
            dfdx = self.pdef.filter_project(dfdx)
            dgdx = torch.stack([self.pdef.filter_project(dgdx[j])
                                for j in range(cfg.m)])
        return dfdx, dgdx

    def step(self, itr: int) -> dict:
        cfg, s = self.cfg, self.state
        u, iters, relres = self.physics.solve(s.xPhys, s.u)
        fx, gx, dfdx, dgdx = self.physics.objective(s.xPhys, u)
        if itr == 1:
            # objective auto-scale (main.cc:68-73)
            s.fscale = float(10.0 / fx)
        dfdx, dgdx = self._gradients(s.x, s.xTilde, dfdx * s.fscale, dgdx)
        xmin, xmax = MMA._movelimit_impl(s.x, cfg.Xmin, cfg.Xmax,
                                         cfg.movlim)
        x_new = self.mma.update(s.x, dfdx, gx, dgdx, xmin, xmax)
        ch, _ = self.mma.design_change(x_new, s.x)
        s.xTilde, s.xPhys = self.filter_project(x_new)
        s.x, s.u = x_new, u
        return {"fx": float(fx), "gx": gx.tolist(), "ch": ch,
                "mnd": self.mnd(), "iters": int(iters),
                "relres": float(relres)}

    def mnd(self) -> float:
        """The measure of non-discreteness of the state's xPhys, mean(4 x
        (1 - x)) over the whole design (Filter.cc:206-225)."""
        xPhys = self.state.xPhys
        local = torch.sum(4.0 * xPhys * (1.0 - xPhys))
        return float(allreduce_sum(self.mesh, local)) / self.grid.nelem

    def set_beta(self, beta: float) -> None:
        """Beta continuation: the new beta re-projects xPhys from xTilde
        (main.cc:92-98)."""
        self.state.beta = beta
        self.state.xPhys = self._project(self.state.xTilde, beta)

    def load(self, x, xPhys, xo1, xo2, U, L, itr: int, fscale: float,
             u: Optional[torch.Tensor] = None) -> None:
        """The state of a restart (blocks of this rank): the design, its
        physical field (also as xTilde), the MMA history at GenSub count
        `itr`, fscale and, when given, the state field."""
        s = self.state
        s.x, s.xTilde, s.xPhys, s.fscale = x, xPhys, xPhys, fscale
        if u is not None:
            s.u = u
        self.mma.state = self.mma.state._replace(L=L, U=U, xo1=xo1,
                                                 xo2=xo2, k=int(itr))
