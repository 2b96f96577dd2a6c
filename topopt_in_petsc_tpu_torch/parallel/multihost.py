"""Starting the ranks of a `-mesh_shape` run: the JAX package's
`parallel/multihost.py` (`initialize`) for `torch.distributed`; rank 0
is the primary (`RankMesh.primary`).

Two ways in:

- under `torchrun` (``WORLD_SIZE`` set), this process is one rank of the
  launch, which must have as many ranks as the mesh has positions; the
  process group comes from torchrun's environment (`python -m
  torch.distributed.run --standalone --nproc_per_node N -m
  topopt_in_petsc_tpu_torch ... -mesh_shape a,b,c`).  A launch whose ranks
  all run on this node (``LOCAL_WORLD_SIZE`` equal to ``WORLD_SIZE``)
  reaches its store and its peers over the loopback interface, so it does
  not depend on the host's name resolving; a launch over several nodes
  keeps what its environment says;
- otherwise `spawn` starts one fresh process per mesh position on this
  node (start method ``spawn``: the CLI may have initialised CUDA, which a
  forked process cannot use), with a `FileStore` rendezvous in a temporary
  directory, so no TCP port is fixed.

In both, every rank joins a gloo group whose collectives time out after
`COLLECTIVE_TIMEOUT`, runs on the CPU with one torch thread or on its card
(parallel/mesh.py), and on a card loads the kernels in turn: rank 0 builds
them (ops/cuda_build.py) before the other ranks load the same library.
Rank 0 prints the mesh line.

A spawned rank writes what it prints to its own log file; rank 0 also to
the terminal.  Any rank that fails ends the run: the launcher stops the
other ranks, prints the last `TAIL_LINES` lines of every rank's log, and
raises `RankFailure`.
"""

from __future__ import annotations

import datetime
import io
import multiprocessing
import os
import pickle
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from topopt_in_petsc_tpu_torch.parallel.mesh import (
    BACKEND,
    RankMesh,
    describe,
    make_rank_mesh,
    rank_device,
)

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)
TAIL_LINES = 40


class RankFailure(RuntimeError):
    """A rank of a spawned run exited with a nonzero code."""


def start_rank(mesh: RankMesh) -> None:
    """What every rank does once its process group is up: one torch
    thread on the CPU, the kernels loaded on a card (rank 0 first), and
    rank 0's mesh line."""
    if mesh.device.type == "cpu":
        torch.set_num_threads(1)
    else:
        from topopt_in_petsc_tpu_torch.ops.cuda_build import LIBRARY

        torch.cuda.set_device(mesh.device)
        if mesh.primary:
            LIBRARY.get()
        dist.barrier()
        if not mesh.primary:
            LIBRARY.get()
    if mesh.primary:
        print(describe(mesh), flush=True)


def _loopback() -> None:
    """The ranks of one node talk over its loopback interface (a gloo
    device on ``lo`` unless the environment names another)."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")


def local_launch_env() -> None:
    """torchrun's environment for a launch on this node alone: the store
    at ``localhost`` (torchrun gives the host's name, which need not
    resolve) and gloo on the loopback interface.  A launch over several
    nodes is left as it is."""
    if os.environ.get("LOCAL_WORLD_SIZE") == os.environ["WORLD_SIZE"]:
        os.environ["MASTER_ADDR"] = "localhost"
        _loopback()


def join_torchrun(mesh_shape, device: str) -> RankMesh:
    """This process as one rank of a torchrun launch."""
    world = int(os.environ["WORLD_SIZE"])
    n = int(np.prod(mesh_shape))
    if world != n:
        raise ValueError(f"-mesh_shape {mesh_shape} has {n} positions but "
                         f"the launch has WORLD_SIZE={world}")
    local_launch_env()
    mesh = make_rank_mesh(mesh_shape, int(os.environ["RANK"]), device)
    dist.init_process_group(BACKEND, rank=mesh.rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)
    start_rank(mesh)
    return mesh


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _host_tree(obj):
    """obj with every tensor as a numpy array (what a rank returns)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_tree(v) for v in obj)
    return obj


def _rank_main(rank: int, shape, device: str, tmp: str, fn: Callable,
               args: tuple) -> None:
    """The target of a spawned rank: fn(mesh, *args) on rank `rank`, its
    result pickled into `tmp`."""
    log = open(os.path.join(tmp, f"rank{rank}.log"), "w", buffering=1)
    if rank == 0:
        sys.stdout = _Tee(sys.stdout, log)
        sys.stderr = _Tee(sys.stderr, log)
    else:
        sys.stdout = sys.stderr = log
    os.environ["LOCAL_RANK"] = str(rank)
    _loopback()
    mesh = make_rank_mesh(shape, rank, device)
    world = mesh.world
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(BACKEND, store=store, rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT)
    start_rank(mesh)
    result = fn(mesh, *args)
    with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(_host_tree(result), f)
    dist.destroy_process_group()
    sys.stdout.flush()


def _tail(path: str, n: int) -> List[str]:
    try:
        with open(path, errors="replace") as f:
            return f.read().splitlines()[-n:]
    except FileNotFoundError:
        return ["(no log)"]


def spawn(mesh_shape, fn: Callable, args_per_rank: Optional[Sequence] = None,
          *, device: str = "cpu") -> list:
    """fn(mesh, *args) on every position of `mesh_shape`, one fresh
    process each (`args_per_rank[r]` for rank r, or no arguments); fn must
    be importable by name (a module-level function of this package).
    Returns the ranks' results in rank order, tensors as numpy arrays.
    Raises `RankFailure`, after printing every rank's last lines, when a
    rank fails."""
    shape = tuple(int(m) for m in mesh_shape)
    world = int(np.prod(shape))
    args_per_rank = list(args_per_rank or [()] * world)
    if len(args_per_rank) != world:
        raise ValueError(f"{len(args_per_rank)} argument sets for "
                         f"{world} ranks")
    rank_device(device)  # no card: raise here, before any rank starts
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="topopt_ranks_") as tmp:
        procs = [
            ctx.Process(target=_rank_main,
                        args=(r, shape, device, tmp, fn,
                              tuple(args_per_rank[r])))
            for r in range(world)
        ]
        for p in procs:
            p.start()
        try:
            while True:
                codes = [p.exitcode for p in procs]
                if all(c is not None for c in codes) or any(
                        c not in (None, 0) for c in codes):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world)]
        if any(codes):
            lines = [f"# mesh run failed: exit codes by rank {codes}"]
            for r, path in enumerate(logs):
                lines.append(f"# ---- rank {r}, last {TAIL_LINES} lines:")
                lines += _tail(path, TAIL_LINES)
            print("\n".join(lines), file=sys.stderr, flush=True)
            raise RankFailure(f"mesh {shape}: ranks exited with {codes}")
        for path in logs[1:]:
            for line in _tail(path, TAIL_LINES):
                if line.startswith("# rank "):
                    print(line, flush=True)
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
