"""The optimization driver loop — reference main.cc:22-141.

Per iteration (main.cc:54-123):
  1. physics: solve KU=F, compute objective/constraints/sensitivities
  2. objective auto-scale to 10.0 at itr 1 (main.cc:68-73)
  3. filter gradient chain rule (main.cc:76)
  4. outer movelimits (main.cc:81)
  5. MMA update (main.cc:85)
  6. inf-norm design change (main.cc:89)
  7. beta continuation if projection (main.cc:92-95)
  8. filter the new design (main.cc:98)
  9. discreteness measure MND (main.cc:102)
 10. log line (main.cc:108-111)
 11. VTU output: itr < 11, every 20th, or on beta change (main.cc:114-116)
 12. restart dump every 10 iterations (main.cc:119-122)
Loop until maxItr or design change <= 0.01 (main.cc:54); final restart dump
and field dump afterwards (main.cc:125-129).

The log lines are the JAX package's, character for character.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.io.restart import (
    RestartManager,
    state_from_numpy,
)
from topopt_in_petsc_tpu_torch.io.vtu import write_state_vtu
from topopt_in_petsc_tpu_torch.models.elasticity import LinearElasticity
from topopt_in_petsc_tpu_torch.opt.filters import DesignFilter
from topopt_in_petsc_tpu_torch.opt.mma import MMA


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    def __init__(self, cfg: TopOptConfig):
        cfg.validate()
        self.cfg = cfg
        self.device = dev = cfg.torch_device()
        print(cfg.banner())

        # STEP 1-2: mesh/config container + physics (main.cc:31-34)
        self.grid = Grid.from_config(cfg)
        self.physics = LinearElasticity(cfg, self.grid, device=dev)
        # STEP 3: filtering (main.cc:37)
        self.filter = DesignFilter(cfg, self.grid, device=dev)
        # STEP 4: output (main.cc:40)
        os.makedirs(cfg.workdir, exist_ok=True)
        self.restart_mgr = RestartManager(cfg.workdir, enabled=cfg.restart)

        dt = cfg.torch_dtype
        self.x = torch.full(self.grid.ne, cfg.volfrac, dtype=dt, device=dev)
        self.xTilde = self.x
        self.xPhys = self.x
        self.u = torch.zeros((*self.grid.nn, 3), dtype=dt, device=dev)
        self.fscale = 1.0
        self.beta = cfg.beta
        self.itr = 0

        # STEP 5: MMA (f64), with optional restart (main.cc:42-44,
        # TopOpt.cc:386-512)
        restart_data = None
        if cfg.restart and cfg.restartFileVec:
            restart_data = self.restart_mgr.load(cfg.restartFileVec)
        if restart_data is not None and not cfg.onlyLoadDesign:
            st = state_from_numpy(restart_data, dev)
            self.itr = st["itr"]
            self.fscale = st["fscale"]
            self.x = st["x"]
            self.xPhys = st["xPhys"]
            self.mma = MMA.from_restart(
                self.grid.nelem, cfg.m, self.grid.ne, self.itr,
                st["xo1"], st["xo2"], st["U"], st["L"], device=dev,
            )
            print(f"# Continue optimization from file: {cfg.restartFileVec}")
            sol = self.restart_mgr.load_state(cfg.restartFileVecSol)
            if sol is not None:
                self.u = torch.as_tensor(sol, dtype=dt, device=dev)
        else:
            if restart_data is not None:  # onlyLoadDesign
                self.x = torch.as_tensor(restart_data["x"], dtype=dt,
                                         device=dev)
                print(f"# Loading design from file: {cfg.restartFileVec}")
            self.mma = MMA(self.grid.nelem, cfg.m, self.grid.ne, device=dev)
        self.xold = self.x

    # -------------------------------------------------------------- #

    def _write_vtu(self, itr: int):
        if not self.cfg.output_cadence_vtu:
            return
        path = os.path.join(self.cfg.workdir, f"output_{itr:05d}.vtu")
        write_state_vtu(
            path, self.grid, self.u, self.x, self.xTilde, self.xPhys
        )

    def _write_restart(self):
        if not self.restart_mgr.enabled:
            return
        xo1, xo2, U, L = self.mma.restart_vectors()
        self.restart_mgr.write(
            self.itr, self.fscale, self.x, self.xPhys, xo1, xo2, U, L,
            self.u,
        )

    # -------------------------------------------------------------- #

    def run(self, max_iters: Optional[int] = None) -> dict:
        cfg = self.cfg
        maxItr = cfg.maxItr if max_iters is None else max_iters

        # STEP 6: filter initial/restarted design (main.cc:48)
        self.xTilde, self.xPhys = self.filter.filter_project(
            self.x, cfg.projectionFilter, self.beta, cfg.eta
        )

        history = {"fx": [], "gx": [], "ch": [], "mnd": [], "iters": [],
                   "time": [], "stalled": []}
        ch = 1.0
        # STEP 7: optimization loop (main.cc:54)
        while self.itr < maxItr and ch > 0.01:
            self.itr += 1
            _sync(self.device)
            t1 = time.perf_counter()

            # physics (main.cc:62)
            ts = time.perf_counter()
            res = self.physics.compute_objective_constraints_sensitivities(
                self.xPhys, self.u
            )
            self.u = res.u
            fx = float(res.fx)
            gx = res.gx.cpu().numpy()
            relres = float(res.relres)
            te = time.perf_counter()
            print(
                f"State solver:  iter: {res.iters}, "
                f"rerr.: {relres:e}, time: {te - ts:f}"
            )
            # convergence-reason rail (PETSc's KSPConvergedReason analogue)
            stalled = res.iters >= cfg.ksp_maxit and relres > cfg.ksp_rtol
            if stalled:
                print(
                    f"WARNING: STATE SOLVER DID NOT CONVERGE in "
                    f"{cfg.ksp_maxit} iterations "
                    f"(rerr {relres:e} > rtol "
                    f"{cfg.ksp_rtol:e}); sensitivities this iteration "
                    f"are unreliable — consider -ksp_type fgmres or "
                    f"more -ksp_maxit"
                )

            # objective scale (main.cc:68-73)
            if self.itr == 1:
                self.fscale = 10.0 / fx
            fx_scaled = fx * self.fscale
            dfdx = res.dfdx * self.fscale
            dgdx = res.dgdx

            # filter chain rule (main.cc:76)
            dfdx, dgdx = self.filter.gradients(
                self.x, self.xTilde, dfdx, dgdx,
                cfg.projectionFilter, self.beta, cfg.eta,
            )

            # movelimits + MMA update (main.cc:81-85)
            xmin, xmax = self.mma.set_outer_movelimit(
                cfg.Xmin, cfg.Xmax, cfg.movlim, self.x
            )
            self.x = self.mma.update(
                self.x, dfdx, res.gx, dgdx, xmin, xmax
            )

            # design change (main.cc:89)
            ch, self.xold = self.mma.design_change(self.x, self.xold)

            # beta continuation (main.cc:92-95)
            changeBeta = False
            if cfg.projectionFilter:
                self.beta, changeBeta = self.filter.increase_beta(
                    self.beta, cfg.betaFinal, gx[0], self.itr, ch
                )

            # filter design (main.cc:98)
            self.xTilde, self.xPhys = self.filter.filter_project(
                self.x, cfg.projectionFilter, self.beta, cfg.eta
            )

            # discreteness (main.cc:102)
            mnd = self.filter.get_mnd(self.xPhys)

            _sync(self.device)
            t2 = time.perf_counter()
            print(
                f"It.: {self.itr}, True fx: {fx:f}, "
                f"Scaled fx: {fx_scaled:f}, gx[0]: {gx[0]:f}, "
                f"ch.: {ch:f}, mnd.: {mnd:f}, time: {t2 - t1:f}"
            )

            history["fx"].append(fx)
            history["gx"].append(float(gx[0]))
            history["ch"].append(ch)
            history["mnd"].append(mnd)
            history["iters"].append(res.iters)
            history["time"].append(t2 - t1)
            history["stalled"].append(stalled)

            # output cadence (main.cc:114-116)
            if self.itr < 11 or self.itr % 20 == 0 or changeBeta:
                self._write_vtu(self.itr)
            # restart cadence (main.cc:119-122)
            if self.itr % 10 == 0:
                self._write_restart()

        # final dumps (main.cc:125-129)
        self._write_restart()
        self._write_vtu(self.itr + 1)
        return history


def run_topopt(cfg: TopOptConfig, max_iters: Optional[int] = None) -> dict:
    if cfg.fused:
        # one step call per iteration over every filter, -filter 2
        # included (the JAX package runs that on its SPMD engine)
        from topopt_in_petsc_tpu_torch.fused_driver import FusedDriver

        return FusedDriver(cfg).run(max_iters)
    return Driver(cfg).run(max_iters)
