"""The single-device fused-step optimization driver (`-fused 1`): the JAX
package's `fused_driver.py`, on every filter.

Each iteration is one `step(state, itr)` call (parallel/fused_step.py: a
fixed sequence of CUDA graphs on the card).  The host advances the loop,
applies beta continuation with the reference's re-projection
(main.cc:92-98), logs and handles the VTU and restart cadences.  Every
write into the state is a `copy_` into its tensors, which are the step's
captured buffers: the restart load, the pre-loop filter and the beta
re-projection.

The log lines are the JAX package's `FusedDriver`'s, character for
character; under `-filter 2` (which the JAX package runs through its SPMD
engine on one device) the bound-violation warning comes before the
`State solver:` line, as its `SpmdDriver` prints it.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.io.mpiio_dat import MPIIODat
from topopt_in_petsc_tpu_torch.io.restart import RestartManager
from topopt_in_petsc_tpu_torch.io.vtu import write_state_vtu
from topopt_in_petsc_tpu_torch.opt.filters import (
    DesignFilter,
    smooth_projection,
)
from topopt_in_petsc_tpu_torch.parallel.fused_step import make_fused_step


def _load(dst: torch.Tensor, value) -> None:
    dst.copy_(torch.as_tensor(np.asarray(value)).reshape(dst.shape))


class FusedDriver:
    def __init__(self, cfg: TopOptConfig):
        cfg.validate()
        self.cfg = cfg
        self.device = cfg.torch_device()
        print(cfg.banner())
        self.step, self.state, aux = make_fused_step(cfg, return_aux=True)
        self.grid = aux["grid"]
        os.makedirs(cfg.workdir, exist_ok=True)
        self.restart_mgr = RestartManager(cfg.workdir, enabled=cfg.restart)
        self.itr = 0
        self.dat = None
        if cfg.output_dat:
            self.dat = MPIIODat(
                os.path.join(cfg.workdir, "output_00000.dat"), self.grid
            )

        if cfg.restart and cfg.restartFileVec:
            data = self.restart_mgr.load(cfg.restartFileVec)
            s = self.state
            if data is not None and not cfg.onlyLoadDesign:
                self.itr = int(data["itr"])
                for f, k in (("x", "x"), ("xPhys", "xPhys"),
                             ("xTilde", "xPhys"), ("xo1", "xo1"),
                             ("xo2", "xo2"), ("U", "U"), ("L", "L"),
                             ("fscale", "fscale")):
                    _load(getattr(s, f), data[k])
                sol = self.restart_mgr.load_state(cfg.restartFileVecSol)
                if sol is not None:
                    _load(s.u, sol)
                print(
                    f"# Continue optimization from file: "
                    f"{cfg.restartFileVec}"
                )
            elif data is not None:
                _load(s.x, data["x"])
                print(f"# Loading design from file: {cfg.restartFileVec}")

    # ------------------------------------------------------------- #

    def _write_outputs(self, itr):
        """The fields of iteration `itr`: to the .dat under -output_dat 1
        (whatever the VTU cadence), then to a .vtu."""
        s = self.state
        if self.dat is not None:
            self.dat.write_state(itr, s.u, s.x, s.xTilde, s.xPhys)
        if not self.cfg.output_cadence_vtu:
            return
        path = os.path.join(self.cfg.workdir, f"output_{itr:05d}.vtu")
        write_state_vtu(path, self.grid, s.u, s.x, s.xTilde, s.xPhys)

    def _write_restart(self):
        if not self.restart_mgr.enabled:
            return
        s = self.state
        self.restart_mgr.write(
            self.itr, float(s.fscale), s.x, s.xPhys, s.xo1, s.xo2, s.U,
            s.L, s.u,
        )

    def _scalars(self):
        """The logged scalars of the state, in one device-to-host copy:
        (fx, fscale, ch, mnd, gx[0], beta, iters, relres, PDE-filter
        bound violation, the PDE solves' iterations under -filter 2)."""
        s, step = self.state, self.step
        pde = list(step.pde_iters.unbind()) if self.cfg.filter == 2 else []
        v = torch.stack([
            t.reshape(()).to(torch.float64)
            for t in (s.fx, s.fscale, s.ch, s.mnd, s.gx[0], s.beta,
                      s.solver_iters, s.solver_relres, step.pde_viol, *pde)
        ]).tolist()
        *vals, iters, relres, viol = v[:9]
        return (*vals, int(iters), relres, viol, [int(k) for k in v[9:]])

    # ------------------------------------------------------------- #

    def run(self, max_iters: Optional[int] = None) -> dict:
        cfg = self.cfg
        maxItr = cfg.maxItr if max_iters is None else max_iters
        s = self.state
        # STEP 6 (main.cc:48-52): (re-)filter the initial or restarted
        # design with the CURRENT beta before the loop (the reference
        # does not checkpoint beta; a restarted run re-projects with the
        # CLI value)
        xTilde, xPhys = self.step.project(s.x, s.beta)
        s.xTilde.copy_(xTilde)
        s.xPhys.copy_(xPhys)
        history = {"fx": [], "gx": [], "ch": [], "mnd": [], "iters": [],
                   "time": [], "stalled": []}
        ch = 1.0
        while self.itr < maxItr and ch > 0.01:
            self.itr += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            self.step(s, self.itr)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t2 = time.perf_counter()

            fx, fscale, ch, mnd, gx0, beta0, iters, relres, viol, \
                pde_iters = self._scalars()

            # beta continuation + reference-exact re-projection
            # (main.cc:92-98: IncreaseBeta THEN FilterProject).  xTilde
            # does not depend on beta, so projecting the state's xTilde
            # is the filter's result exactly, without a PDE solve.
            changeBeta = False
            if cfg.projectionFilter:
                beta, changeBeta = DesignFilter.increase_beta(
                    beta0, cfg.betaFinal, gx0, self.itr, ch
                )
                # changeBeta only gates the VTU cadence (main.cc:114);
                # the clamp-to-betaFinal case moves beta with
                # changed=False (Filter.cc:281-284) and must still
                # re-project
                if beta != beta0:
                    s.beta.fill_(beta)
                    s.xPhys.copy_(
                        smooth_projection(s.xTilde, s.beta, self.step.eta)
                    )
                    mnd = float(torch.mean(4.0 * s.xPhys * (1.0 - s.xPhys)))

            if cfg.filter == 2:
                # the port's own line: the iterations of this step's PDE
                # solves (dfdx, each dgdx, the design)
                print(f"# PDE filter iterations: {pde_iters}")
                if viol > 1e-4:
                    # bound-violation warning (Filter.cc:82-97)
                    print(
                        "BOUND VIOLATION IN PDEFILTER - INCREASE RMIN OR "
                        f"MESH RESOLUTION: xPhys = {viol:f}"
                    )
            print(
                f"State solver:  iter: {iters}, "
                f"rerr.: {relres:e}, time: {t2 - t1:f}"
            )
            stalled = iters >= cfg.ksp_maxit and relres > cfg.ksp_rtol
            if stalled:
                print(
                    f"WARNING: STATE SOLVER DID NOT CONVERGE in "
                    f"{cfg.ksp_maxit} iterations "
                    f"(rerr {relres:e} > rtol "
                    f"{cfg.ksp_rtol:e}); sensitivities this iteration "
                    f"are unreliable — consider -ksp_type fgmres or "
                    f"more -ksp_maxit"
                )
            print(
                f"It.: {self.itr}, True fx: {fx:f}, "
                f"Scaled fx: {fx * fscale:f}, gx[0]: {gx0:f}, "
                f"ch.: {ch:f}, mnd.: {mnd:f}, time: {t2 - t1:f}"
            )
            history["fx"].append(fx)
            history["gx"].append(gx0)
            history["ch"].append(ch)
            history["mnd"].append(mnd)
            history["iters"].append(iters)
            history["time"].append(t2 - t1)
            history["stalled"].append(stalled)

            if self.itr < 11 or self.itr % 20 == 0 or changeBeta:
                self._write_outputs(self.itr)
            if self.itr % 10 == 0:
                self._write_restart()

        self._write_restart()
        self._write_outputs(self.itr + 1)
        return history
