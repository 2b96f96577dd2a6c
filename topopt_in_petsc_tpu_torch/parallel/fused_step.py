"""One fused optimization iteration on one device: the JAX package's
`parallel/fused_step.py` (`OptState`, `make_fused_step` and its three
variants), the hot loop of `-fused 1` (fused_driver.py).

The iteration is main.cc:54-123 whole: state solve, objective and
sensitivities, filter chain rule, movelimits, MMA dual solve, design
filter.  No loop trip in it reads the device from the host.  Its
data-dependent loops (the state solve's Krylov iterations, each PDE-filter
solve and MMA's dual interior point) run as segments of `SEGMENT`
predicated trips (solvers/cg.py `pcg_trips`, opt/mma.py `dip_trips`),
whose results are the JAX package's `while_loop`s bit for bit; between two
segments the host reads one done flag and nothing else.

The iteration is a fixed sequence of stages over static buffers:

- pre: SIMP, the MG setup and the state solve's Krylov carry;
- pcg (loop): `SEGMENT` outer iterations; every V-cycle's coarse CG is
  `coarse_maxit` predicated trips;
- head: the objective (kernel K2), fscale and the filter chain rule; under
  `-filter 2` each gradient field then takes its own PDE solve, as a
  pde_start stage, a pde loop and a pde_finish stage;
- mma: movelimits, the subproblem and the dual's carry, then the dual's
  loop;
- post: x(lambda), ch and the design filter (under `-filter 2` one more
  PDE solve, with the bound violation kept in `FusedStep.pde_viol`), MND,
  and a `copy_` of the new state into the state buffers.

On `cuda` the steady variant's stages are CUDA graphs, captured from the
same stage functions after their first eager run and replayed from then
on, all in one memory pool on one side stream; the first two iterations,
whose variants run once each, stay eager.  The state passed to the step is
updated in place: its tensors are the graphs' buffers, so whatever writes
into the state afterwards writes with `copy_` (a field bound to a new
tensor would leave the graphs reading the old one, which `__call__`
refuses).  A capture that fails raises.  On `-device cpu` the same stage
functions run eagerly.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.models.elasticity import LinearElasticity
from topopt_in_petsc_tpu_torch.ops.cuda_build import KERNELS
from topopt_in_petsc_tpu_torch.opt.filters import (
    DesignFilter,
    smooth_projection,
)
from topopt_in_petsc_tpu_torch.opt.mma import MMA
from topopt_in_petsc_tpu_torch.solvers.cg import (
    SEGMENT,
    pcg_active,
    pcg_result,
)


class OptState(NamedTuple):
    x: torch.Tensor  # design
    xTilde: torch.Tensor  # filtered design
    xPhys: torch.Tensor  # physical design
    u: torch.Tensor  # state field (warm start), nodal (nx, ny, nz, 3)
    L: torch.Tensor  # MMA lower asymptotes
    U: torch.Tensor  # MMA upper asymptotes
    xo1: torch.Tensor  # design history k-1
    xo2: torch.Tensor  # design history k-2
    fscale: torch.Tensor  # objective scale, 0-d
    beta: torch.Tensor  # Heaviside projection sharpness, 0-d
    fx: torch.Tensor  # last compliance, 0-d
    gx: torch.Tensor  # last constraints, (m,)
    ch: torch.Tensor  # last design change, 0-d
    mnd: torch.Tensor  # measure of non-discreteness (Filter.cc:206-225)
    solver_iters: torch.Tensor  # 0-d int32
    solver_relres: torch.Tensor  # 0-d


def _fresh(carry):
    """A loop carry in tensors of its own, so that a segment's in-place
    update never writes into a buffer the carry was started from."""
    return type(carry)(*(t.clone() for t in carry))


def _assign(dst, src) -> None:
    for a, b in zip(dst, src):
        a.copy_(b)


class _Stage(NamedTuple):
    """`fn()` updates the step's buffers; a loop stage's `fn` runs one
    segment and returns its 0-d flag "run another segment"."""

    fn: object
    loop: bool = False


class _Graph:
    """One stage captured as a CUDA graph, with the kernel launches it
    recorded: a replay launches them, so it adds them to the counts."""

    def __init__(self, stage: _Stage, stream, pool):
        before = [k.captured for k in KERNELS]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.flag = stage.fn()
        self.loop = stage.loop
        self.launches = [k.captured - b for k, b in zip(KERNELS, before)]

    def replay(self) -> None:
        self.graph.replay()
        for k, n in zip(KERNELS, self.launches):
            k.launches += n


class FusedStep:
    """`step(state, itr)`: one optimization iteration, in place on the
    state's tensors; `itr` (1-based) selects the variant as the JAX
    package's does: itr == 1 sets fscale = 10/fx (main.cc:68-73), itr <= 2
    takes fresh asymptotes (GenSub k < 3, MMA.cc:532-537)."""

    def __init__(self, cfg, device: torch.device, *, graphs: bool = True):
        self.cfg = cfg
        self.device = dev = torch.device(device)
        self.grid = grid = Grid.from_config(cfg)
        self.physics = LinearElasticity(cfg, grid, device=dev)
        # the JAX package's single-program PDE filter has no smoke solve
        self.filt = DesignFilter(cfg, grid, device=dev, pde_smoke=False)
        self.pdef = self.filt.pdef
        # the field dtype (f32) with f64 sums, as the JAX fused step runs
        # it (its split driver and the port's run f64)
        self.mma = MMA(grid.nelem, cfg.m, grid.ne, device=dev,
                       dtype=cfg.torch_dtype, precise_dots=cfg.precise_dots)
        self.dtype = cfg.torch_dtype
        self.eta = torch.tensor(cfg.eta, dtype=self.dtype, device=dev)
        self.projection = bool(cfg.projectionFilter)
        # the last design filter's bound violation (-filter 2 only)
        self.pde_viol = torch.zeros((), dtype=self.dtype, device=dev)
        self.b = SimpleNamespace()  # buffers passed between stages
        self.graphs: Optional[list] = None
        self._capture = graphs and dev.type == "cuda"
        if dev.type == "cuda":
            self.stream = torch.cuda.Stream(dev)
            self._flag = torch.zeros((), dtype=torch.bool, pin_memory=True)

    # -- the state --------------------------------------------------------- #

    def init_state(self) -> OptState:
        """The JAX package's init state: the design at volfrac through the
        pre-loop filter, pre-populated asymptotes x0 -+ span/2.  Under
        `-filter 2` the filter is not run here (the JAX package's engine
        starts xTilde at x0), so the PDE warm start is left as it is for
        the driver's pre-loop filter."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        full = lambda v, shape=(): torch.full(  # noqa: E731
            shape, v, dtype=dt, device=dev)
        x0 = full(cfg.volfrac, self.grid.ne)
        beta = full(cfg.beta)
        if self.filt.filterType == 2:
            xt0 = x0
            xp0 = (smooth_projection(x0, beta, self.eta)
                   if self.projection else x0)
        else:
            xt0, xp0 = self.filt._project_impl(
                x0, beta, self.eta, projection=self.projection
            )
        span = cfg.Xmax - cfg.Xmin
        relres_dt = torch.float64 if cfg.precise_dots else dt
        return OptState(
            x=x0, xTilde=xt0.clone(), xPhys=xp0.clone(),
            u=torch.zeros((*self.grid.nn, 3), dtype=dt, device=dev),
            L=x0 - 0.5 * span, U=x0 + 0.5 * span,
            xo1=x0.clone(), xo2=x0.clone(),
            fscale=full(1.0), beta=beta, fx=full(0.0),
            gx=torch.zeros((cfg.m,), dtype=dt, device=dev),
            ch=full(1.0), mnd=full(1.0),
            solver_iters=torch.zeros((), dtype=torch.int32, device=dev),
            solver_relres=torch.zeros((), dtype=relres_dt, device=dev),
        )

    def project(self, x: torch.Tensor, beta: torch.Tensor):
        """FilterProject of a design with the state's beta: (xTilde,
        xPhys).  Eager, outside the step; under `-filter 2` it advances
        the PDE warm start as the step's own filter solves do."""
        return self.filt._project_impl(x, beta, self.eta,
                                       projection=self.projection)

    # -- the stages -------------------------------------------------------- #

    def _stages(self, s: OptState, first: bool, fresh: bool) -> list:
        cfg, b, ph, mma, pdef = self.cfg, self.b, self.physics, self.mma, \
            self.pdef

        def pre():
            b.levels, carry = ph.solve_start(s.xPhys, s.u)
            b.pcg = _fresh(carry)

        def pcg_seg():
            _assign(b.pcg, ph.solve_advance(b.levels, b.pcg, SEGMENT))
            return pcg_active(b.pcg, rtol=cfg.ksp_rtol,
                              maxiter=cfg.ksp_maxit)

        def head():
            s.u.copy_(ph.solution(b.pcg.x))
            b.fx, b.gx, dfdx, dgdx = ph._objective_parts(s.xPhys, s.u)
            b.fscale = 10.0 / b.fx if first else s.fscale
            # filters 0 and 1 filter here; under -filter 2 only the
            # projection's chain rule applies, the PDE solves follow
            b.dfdx, b.dgdx = self.filt._gradients_impl(
                s.x, s.xTilde, dfdx * b.fscale, dgdx, s.beta, self.eta,
                projection=self.projection,
            )
            b.fields = [b.dfdx, *b.dgdx]

        stages = [_Stage(pre), _Stage(pcg_seg, loop=True), _Stage(head)]

        def pde_seg():
            _assign(b.pde, pdef.advance(b.pde, SEGMENT))
            return pdef.active(b.pde)

        def pde_solve(field, out):
            """The stages of one PDE solve of the field `field()` returns,
            whose filtered field goes to `out`."""
            def start():
                b.pde = _fresh(pdef.start(field()))

            def finish():
                out(pdef.finish(b.pde))

            return [_Stage(start), _Stage(pde_seg, loop=True),
                    _Stage(finish)]

        if pdef is not None:
            b.filtered = [None] * (1 + cfg.m)
            for j in range(1 + cfg.m):
                def keep(xt, j=j):
                    b.filtered[j] = xt

                stages += pde_solve(lambda j=j: b.fields[j], keep)

        def mma_start():
            if pdef is not None:
                b.dfdx, b.dgdx = b.filtered[0], torch.stack(b.filtered[1:])
            xmin, xmax = mma._movelimit_impl(s.x, cfg.Xmin, cfg.Xmax,
                                             cfg.movlim)
            b.sub = mma._subproblem(
                s.x, b.dfdx, b.gx, b.dgdx, xmin, xmax, s.L, s.U, s.xo1,
                s.xo2, fresh_asymptotes=fresh,
            )
            b.dip = _fresh(mma.dip_start())

        def dip_seg():
            _assign(b.dip, mma.dip_trips(b.dip, b.sub, SEGMENT))
            return mma.dip_active(b.dip)

        def post_x():
            b.x_new = mma.dip_x(b.dip, b.sub)
            b.ch = torch.max(torch.abs(b.x_new - s.x))

        def post():
            if pdef is None:
                post_x()
                b.xTilde, b.xPhys = self.project(b.x_new, s.beta)
            self._write_state(s)

        stages += [_Stage(mma_start), _Stage(dip_seg, loop=True)]
        if pdef is not None:
            stages.append(_Stage(post_x))

            def design(xt):
                # bound-violation clip (Filter.cc:76-101); the violation
                # is kept for the driver's warning
                self.pde_viol.copy_(
                    torch.maximum(torch.max(-xt), torch.max(xt - 1.0)))
                b.xTilde = torch.clamp(xt, 0.0, 1.0)
                b.xPhys = (
                    smooth_projection(b.xTilde, s.beta, self.eta)
                    if self.projection else b.xTilde
                )

            stages += pde_solve(lambda: b.x_new, design)
        return stages + [_Stage(post)]

    def _write_state(self, s: OptState) -> None:
        """The new state into the state buffers, in the JAX step's
        order: the history shifts before x is replaced."""
        b = self.b
        s.xo2.copy_(s.xo1)
        s.xo1.copy_(s.x)
        s.x.copy_(b.x_new)
        s.xTilde.copy_(b.xTilde)
        s.xPhys.copy_(b.xPhys)
        s.L.copy_(b.sub[0])
        s.U.copy_(b.sub[1])
        s.fscale.copy_(b.fscale)
        s.fx.copy_(b.fx)
        s.gx.copy_(b.gx)
        s.ch.copy_(b.ch)
        s.mnd.copy_(torch.mean(4.0 * b.xPhys * (1.0 - b.xPhys)))
        s.solver_iters.copy_(b.pcg.k)
        s.solver_relres.copy_(pcg_result(b.pcg).relres)

    # -- running them ------------------------------------------------------ #

    def _more(self, flag: torch.Tensor) -> bool:
        """The host's one read per segment: the loop's flag, through a
        pinned buffer on the card."""
        if flag.device.type != "cuda":
            return bool(flag)
        self._flag.copy_(flag, non_blocking=True)
        self.stream.synchronize()
        return bool(self._flag)

    def _run(self, stages: list) -> None:
        for st in stages:
            flag = st.fn()
            while st.loop and self._more(flag):
                flag = st.fn()

    def _replay(self) -> None:
        for g in self.graphs:
            g.replay()
            while g.loop and self._more(g.flag):
                g.replay()

    def __call__(self, s: OptState, itr: int = 3) -> OptState:
        first, fresh = itr == 1, itr <= 2
        if self.device.type != "cuda":
            self._run(self._stages(s, first, fresh))
            return s
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            if self.graphs is not None and not fresh:
                if [t.data_ptr() for t in s] != self._buffers:
                    raise ValueError(
                        "the state's tensors are not the captured "
                        "buffers: write into them with copy_"
                    )
                self._replay()
            else:
                stages = self._stages(s, first, fresh)
                # the first steady iteration runs eagerly (the warm-up:
                # kernel build, cuBLAS and cuFFT plans) and is then
                # captured, its stages in order into one pool
                self._run(stages)
                if self._capture and not fresh:
                    pool = torch.cuda.graph_pool_handle()
                    self.graphs = [_Graph(st, self.stream, pool)
                                   for st in stages]
                    self._buffers = [t.data_ptr() for t in s]
        caller.wait_stream(self.stream)
        return s


def make_fused_step(cfg, device=None, return_aux: bool = False, *,
                    graphs: bool = True):
    """(step, init_state), or (step, init_state, aux) with aux = {grid,
    physics, filt, mma} when `return_aux`.  `step(state, itr)` updates
    the state in place and returns it.  `device` defaults to the
    configuration's (`-device`).  `graphs=False` keeps every iteration
    eager on `cuda` too (the reference the graph replay is held to)."""
    cfg.validate()
    dev = cfg.torch_device() if device is None else torch.device(device)
    step = FusedStep(cfg, dev, graphs=graphs)
    init = step.init_state()
    if return_aux:
        aux = {"grid": step.grid, "physics": step.physics,
               "filt": step.filt, "mma": step.mma}
        return step, init, aux
    return step, init
