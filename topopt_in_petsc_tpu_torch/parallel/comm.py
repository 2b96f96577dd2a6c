"""Communication between the ranks of the rank grid: the role of
`lax.ppermute` and `lax.psum` / `lax.pmax` in the JAX package's halo
engine (`parallel/spmd.py`), over `torch.distributed` with gloo.

- `exchange`: one plane (or slab) exchange along one axis.  A rank sends
  one tensor to its lower and one to its higher neighbour and receives the
  neighbours' counterparts; at the domain's edge it receives nothing
  (None), where `ppermute` gives zeros.  A plane travels in its tensor's
  dtype: a bf16 V-cycle level's planes are sent as bf16 and added in
  bf16, as the JAX engine's `ppermute` of the level's array.  What is sent is a copy taken
  before the call returns, so a caller may update the planes in place
  afterwards: both copies of a shared plane then add the same pre-update
  values.
- `allreduce_sum`, `allreduce_max`: a global sum (in float64) or maximum
  of a scalar or small vector, by gloo's allreduce, whose ring reduces
  each element along one path and hands the result to every rank: the
  same bits on every rank, so every loop of the engine that stops on a
  reduced value (the Krylov solves, the coarse CG, MMA's dual) takes the
  same number of trips on every rank, which gloo needs to not hang.
- `gather`, `scatter`: whole blocks to and from rank 0, for IO.

gloo moves CPU tensors only: a tensor on the card is copied into a pinned
host buffer (`RankMesh.pinned`), and the stream synchronised, before it
is sent, and what arrives is copied back to the card.  Planes of the y and
z axes are strided in both field layouts; they are made contiguous in
that copy.  Each exchange and reduction adds to the rank's `comm` counts
the host's wait for the device and the transfer's own seconds.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from topopt_in_petsc_tpu_torch.parallel.mesh import RankMesh


def _to_host(mesh: RankMesh, key, t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of t (pinned and reused on a card; the
    caller synchronises the stream before reading it)."""
    if not mesh.staged:
        return t.clone(memory_format=torch.contiguous_format)
    buf = mesh.pinned(key, t.shape, t.dtype)
    buf.copy_(t, non_blocking=True)
    return buf


def _host_buffer(mesh: RankMesh, key, shape, dtype) -> torch.Tensor:
    if not mesh.staged:
        return torch.empty(shape, dtype=dtype)
    return mesh.pinned(key, shape, dtype)


def _count(mesh: RankMesh, kind: str, t0: float, t1: float) -> None:
    """One `kind` of communication: the host waited for the device from
    t0 to t1, and the transfer took from t1 to now."""
    c = mesh.comm
    c[kind] += 1
    c["wait_s"] += t1 - t0
    c["wire_s"] += time.perf_counter() - t1


def _to_device(mesh: RankMesh, t: torch.Tensor) -> torch.Tensor:
    """t on this rank's device; from a pinned buffer the copy completes
    before the buffer can be reused."""
    if not mesh.staged:
        return t
    return t.to(mesh.device, non_blocking=False)


def exchange(mesh: RankMesh, axis: int, to_lower: torch.Tensor,
             to_higher: torch.Tensor
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(from_lower, from_higher) along `axis`: the lower neighbour's
    `to_higher` and the higher neighbour's `to_lower`, on this rank's
    device, or None where there is no neighbour.  Every rank of the grid
    calls it with tensors of the same shapes."""
    lower, higher = mesh.neighbour(axis, -1), mesh.neighbour(axis, +1)
    sends, recvs = [], {}
    if lower is not None:
        sends.append((lower, _to_host(mesh, ("send", axis, -1), to_lower)))
        recvs[lower] = _host_buffer(mesh, ("recv", axis, -1),
                                    to_higher.shape, to_higher.dtype)
    if higher is not None:
        sends.append((higher, _to_host(mesh, ("send", axis, +1),
                                       to_higher)))
        recvs[higher] = _host_buffer(mesh, ("recv", axis, +1),
                                     to_lower.shape, to_lower.dtype)
    t0 = time.perf_counter()
    if mesh.staged and sends:
        torch.cuda.current_stream(mesh.device).synchronize()
    t1 = time.perf_counter()
    works = [dist.isend(buf, dst) for dst, buf in sends]
    works += [dist.irecv(buf, src) for src, buf in recvs.items()]
    for w in works:
        w.wait()
    got = {src: _to_device(mesh, buf) for src, buf in recvs.items()}
    _count(mesh, "exchanges", t0, t1)
    return got.get(lower), got.get(higher)


def _allreduce(mesh: RankMesh, t: torch.Tensor, op) -> torch.Tensor:
    t0 = time.perf_counter()
    host = t.detach().to("cpu", copy=True)
    t1 = time.perf_counter()
    dist.all_reduce(host, op=op)
    out = host.to(t.device)
    _count(mesh, "reductions", t0, t1)
    return out


def allreduce_sum(mesh: RankMesh, t: torch.Tensor) -> torch.Tensor:
    """Global sum of t (0-d or a small vector), on t's device and in its
    dtype, summed over the ranks in float64."""
    return _allreduce(mesh, t.to(torch.float64),
                      dist.ReduceOp.SUM).to(t.dtype)


def allreduce_max(mesh: RankMesh, t: torch.Tensor) -> torch.Tensor:
    """Global maximum of t (0-d or a small vector), on t's device."""
    return _allreduce(mesh, t, dist.ReduceOp.MAX)


def gather(mesh: RankMesh, t: torch.Tensor) -> Optional[List[np.ndarray]]:
    """Every rank's block t (the same shape on every rank) as numpy arrays
    in rank order, on rank 0; None on the other ranks."""
    local = t.detach().to("cpu").contiguous()
    parts = ([torch.empty_like(local) for _ in range(mesh.world)]
             if mesh.primary else None)
    dist.gather(local, parts, dst=0)
    return [p.numpy() for p in parts] if mesh.primary else None


def scatter(mesh: RankMesh, blocks: Optional[Sequence[np.ndarray]], shape,
            dtype: torch.dtype) -> torch.Tensor:
    """This rank's block of `blocks` (given on rank 0: one array of
    `shape` per rank, in rank order) as a tensor on its device."""
    local = torch.empty(tuple(shape), dtype=dtype)
    parts = None
    if mesh.primary:
        parts = [torch.as_tensor(np.ascontiguousarray(b)).to(dtype)
                 for b in blocks]
    dist.scatter(local, parts, src=0)
    return local.to(mesh.device)
