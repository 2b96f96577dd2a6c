"""The optimization driver of `-mesh_shape`: the JAX package's
`parallel/spmd_driver.py` (`SpmdDriver`), one instance per rank.

Each rank runs the main.cc loop on its blocks, one `SpmdStep` per
iteration (parallel/spmd_model.py); every rank takes the same decisions
from the same reduced numbers.  Rank 0 prints the banner and the JAX
`SpmdDriver`'s log lines and writes what the run writes, from fields
gathered to it (parallel/podio.py): VTU at `-output_cadence_vtu`, the
`.dat` under `-output_dat`, and restart files in the port's format
(io/restart.py), whose arrays are global, so a run resumes on any mesh
shape or on one device.  At the end every rank prints one `# rank r
launches {...} comm {...}` line with its launch counts of K1-K4 and
K1-bf16, its communication counts and seconds (`RankMesh.comm`) and, on a
card, its peak device memory.  Under `-profile_dir` each rank writes its
own trace (`<profile_dir>/rank<r>/trace.json`, utils/profiling.py).

`run_mesh` is the CLI's entry (driver.py): under torchrun this process is
one rank; otherwise it spawns the mesh's ranks (parallel/multihost.py)
and returns rank 0's history.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.io.mpiio_dat import MPIIODat
from topopt_in_petsc_tpu_torch.io.restart import RestartManager
from topopt_in_petsc_tpu_torch.io.vtu import write_state_vtu
from topopt_in_petsc_tpu_torch.ops.blocked_hex import (
    HEX_OPERATOR,
    HEX_OPERATOR_BF16,
)
from topopt_in_petsc_tpu_torch.ops.nodal_hex import HELMHOLTZ, NODAL_HEX
from topopt_in_petsc_tpu_torch.ops.quadform import QUADFORM
from topopt_in_petsc_tpu_torch.opt.filters import DesignFilter
from topopt_in_petsc_tpu_torch.parallel import multihost, podio
from topopt_in_petsc_tpu_torch.parallel.mesh import RankMesh
from topopt_in_petsc_tpu_torch.parallel.spmd_model import SpmdStep
from topopt_in_petsc_tpu_torch.utils.profiling import trace_to

# the kernels of the mesh path, by the names of the kernel table
MESH_KERNELS = {"K1": HEX_OPERATOR, "K2": QUADFORM, "K3": HELMHOLTZ,
                "K4": NODAL_HEX, "K1-bf16": HEX_OPERATOR_BF16}


def _quiet(*args, **kwargs) -> None:
    pass


class SpmdDriver:
    def __init__(self, cfg: TopOptConfig, mesh: RankMesh):
        cfg.validate()
        self.cfg = cfg
        self.mesh = mesh
        self.log = print if mesh.primary else _quiet
        self.log(cfg.banner())
        self.step = SpmdStep(cfg, mesh, log=self.log)
        self.grid = self.step.grid
        self.decomp = self.step.decomp
        self.restart_mgr = RestartManager(cfg.workdir, enabled=cfg.restart)
        self.itr = 0
        self.dat = None
        if mesh.primary:
            os.makedirs(cfg.workdir, exist_ok=True)
            if cfg.output_dat:
                self.dat = MPIIODat(
                    os.path.join(cfg.workdir, "output_00000.dat"),
                    self.grid)
        if cfg.restart and cfg.restartFileVec:
            self._load_restart()

    # -- restart and output ------------------------------------------ #

    def _load_restart(self) -> None:
        """Every rank takes its blocks of the checkpoint rank 0 reads."""
        cfg, mesh, d, dt = self.cfg, self.mesh, self.decomp, \
            self.step.dtype
        data = sol = None
        if mesh.primary:
            data = self.restart_mgr.load(cfg.restartFileVec)
            if data is not None and not cfg.onlyLoadDesign:
                sol = self.restart_mgr.load_state(cfg.restartFileVecSol)
        found = [data is not None, sol is not None,
                 None if data is None else (int(data["itr"]),
                                            float(data["fscale"]))]
        if mesh.world > 1:
            dist.broadcast_object_list(found, src=0)
        has_data, has_sol, scalars = found
        if not has_data:
            return

        def elem(key):
            return podio.scatter_elem(
                mesh, d, None if data is None else data[key], dt)

        if cfg.onlyLoadDesign:
            self.step.state.x = elem("x")
            self.log(f"# Loading design from file: {cfg.restartFileVec}")
            return
        fields = [elem(k) for k in ("x", "xPhys", "xo1", "xo2", "U", "L")]
        u = podio.scatter_nodal(mesh, d, sol, dt) if has_sol else None
        self.itr = scalars[0]
        self.step.load(*fields, itr=scalars[0], fscale=scalars[1], u=u)
        self.log(f"# Continue optimization from file: {cfg.restartFileVec}")

    def _write_outputs(self, itr: int) -> None:
        cfg = self.cfg
        if not (cfg.output_cadence_vtu or cfg.output_dat):
            return
        mesh, d, s = self.mesh, self.decomp, self.step.state
        x, xTilde, xPhys = (podio.gather_elem(mesh, d, t)
                            for t in (s.x, s.xTilde, s.xPhys))
        u = podio.gather_nodal(mesh, d, s.u)
        if not mesh.primary:
            return
        if self.dat is not None:
            self.dat.write_state(itr, u, x, xTilde, xPhys)
        if cfg.output_cadence_vtu:
            path = os.path.join(cfg.workdir, f"output_{itr:05d}.vtu")
            write_state_vtu(path, self.grid, u, x, xTilde, xPhys)

    def _write_restart(self) -> None:
        if not self.cfg.restart:
            return
        mesh, d, s = self.mesh, self.decomp, self.step.state
        xo1, xo2, U, L = self.step.mma.restart_vectors()
        fields = [podio.gather_elem(mesh, d, t)
                  for t in (s.x, s.xPhys, xo1, xo2, U, L)]
        u = podio.gather_nodal(mesh, d, s.u)
        if mesh.primary:
            self.restart_mgr.write(self.itr, s.fscale, *fields, u)

    # -- the loop ------------------------------------------------------ #

    def _sync(self) -> None:
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)

    def run(self, max_iters: Optional[int] = None) -> dict:
        cfg, step, log = self.cfg, self.step, self.log
        maxItr = cfg.maxItr if max_iters is None else max_iters
        s = step.state
        # STEP 6 (main.cc:48-52): filter the initial or restarted design
        # with the current beta before the loop
        s.xTilde, s.xPhys = step.filter_project(s.x)
        history = {"fx": [], "gx": [], "ch": [], "mnd": [], "iters": [],
                   "time": [], "stalled": []}
        ch = 1.0
        while self.itr < maxItr and ch > 0.01:
            self.itr += 1
            self._sync()
            t1 = time.perf_counter()
            r = step.step(self.itr)
            self._sync()
            t2 = time.perf_counter()
            fx, ch, mnd, gx0 = r["fx"], r["ch"], r["mnd"], r["gx"][0]
            iters, relres = r["iters"], r["relres"]

            # beta continuation (main.cc:92-95); any move of beta
            # re-projects (main.cc:98), and the MND is the re-projected
            # design's (main.cc:102), as in both fused drivers; the JAX
            # SpmdDriver logs the MND from before the re-projection
            # (ROADMAP queue 3)
            changeBeta = False
            if cfg.projectionFilter:
                beta0 = s.beta
                # its "Beta has been increased" line from rank 0 only
                with contextlib.nullcontext() if self.mesh.primary else \
                        contextlib.redirect_stdout(io.StringIO()):
                    beta, changeBeta = DesignFilter.increase_beta(
                        beta0, cfg.betaFinal, gx0, self.itr, ch)
                if beta != beta0:
                    step.set_beta(beta)
                    mnd = step.mnd()
            if cfg.filter == 2 and step.pde_viol > 1e-4:
                # bound-violation warning (Filter.cc:82-97)
                log("BOUND VIOLATION IN PDEFILTER - INCREASE RMIN OR "
                    f"MESH RESOLUTION: xPhys = {step.pde_viol:f}")
            log(f"State solver:  iter: {iters}, "
                f"rerr.: {relres:e}, time: {t2 - t1:f}")
            stalled = iters >= cfg.ksp_maxit and relres > cfg.ksp_rtol
            if stalled:
                log(f"WARNING: STATE SOLVER DID NOT CONVERGE in "
                    f"{cfg.ksp_maxit} iterations "
                    f"(rerr {relres:e} > rtol "
                    f"{cfg.ksp_rtol:e}); sensitivities this iteration "
                    f"are unreliable — consider -ksp_type fgmres or "
                    f"more -ksp_maxit")
            log(f"It.: {self.itr}, True fx: {fx:f}, "
                f"Scaled fx: {fx * s.fscale:f}, gx[0]: {gx0:f}, "
                f"ch.: {ch:f}, mnd.: {mnd:f}, time: {t2 - t1:f}")
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


def run_rank(mesh: RankMesh, cfg: TopOptConfig,
             max_iters: Optional[int] = None) -> dict:
    """One rank's run: its history on rank 0 ({} elsewhere), after the
    rank's launch-count line; under `-profile_dir` traced to
    `<profile_dir>/rank<r>/trace.json`."""
    trace = contextlib.nullcontext()
    if cfg.profile_dir:
        trace = trace_to(os.path.join(cfg.profile_dir, f"rank{mesh.rank}"),
                         mesh.device)
    with trace:
        history = SpmdDriver(cfg, mesh).run(max_iters)
    counts = {name: k.launches for name, k in MESH_KERNELS.items()}
    comm = {k: round(v, 6) for k, v in mesh.comm.items()}
    line = (f"# rank {mesh.rank} launches {json.dumps(counts)} "
            f"comm {json.dumps(comm)}")
    if mesh.device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(mesh.device)
        line += f" max_memory_allocated {peak}"
    print(line, flush=True)
    return history if mesh.primary else {}


def run_mesh(cfg: TopOptConfig, max_iters: Optional[int] = None) -> dict:
    """The run of `cfg` over its mesh (module docstring)."""
    if "WORLD_SIZE" in os.environ:
        mesh = multihost.join_torchrun(cfg.mesh_shape, cfg.device)
        try:
            return run_rank(mesh, cfg, max_iters)
        finally:
            dist.destroy_process_group()
    n = int(np.prod(cfg.mesh_shape))
    return multihost.spawn(cfg.mesh_shape, run_rank,
                           [(cfg, max_iters)] * n, device=cfg.device)[0]
