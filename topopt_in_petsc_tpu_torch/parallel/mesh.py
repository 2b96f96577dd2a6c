"""The rank grid of the multi-device engine: the JAX package's
`parallel/mesh.py` (`make_device_mesh`, an ('x', 'y', 'z') device mesh)
as a grid of `torch.distributed` ranks.

Rank r sits at the C-order position of r in the (mx, my, mz) grid, as
device r does in the JAX mesh (`np.array(devices).reshape(mesh_shape)`),
and owns the element block at that position (parallel/decomp.py).  On
each axis it has a lower and a higher neighbour, or none at the domain's
edge.

Backend rule: the ranks talk over gloo.  NCCL refuses two ranks of one
communicator on one device, and the ranks of a run may share one card,
so the collectives are gloo's; gloo's `send`/`recv` take CPU tensors
only, so every plane or scalar that lives on the card is staged through
pinned host memory (parallel/comm.py).  The kernels still run on the
card: rank r computes on ``cuda:(LOCAL_RANK % device_count)``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

BACKEND = "gloo"


@dataclasses.dataclass
class RankMesh:
    """This rank's place in the (mx, my, mz) rank grid, its device, the
    pinned host buffers its exchanges reuse, and what its communication
    cost (`comm`: parallel/comm.py counts every plane exchange and
    reduction, the seconds the host waited for the device before it could
    send, and the seconds of the transfer itself)."""

    shape: Tuple[int, int, int]
    rank: int
    device: torch.device
    _pinned: dict = dataclasses.field(default_factory=dict, repr=False)
    comm: dict = dataclasses.field(default_factory=lambda: {
        "exchanges": 0, "reductions": 0, "wait_s": 0.0, "wire_s": 0.0})

    def __post_init__(self):
        self.world = int(np.prod(self.shape))
        self.coords = tuple(
            int(c) for c in np.unravel_index(self.rank, self.shape))
        self.primary = self.rank == 0
        # do this rank's tensors live on a card, so that what it sends
        # goes through pinned host memory?
        self.staged = self.device.type == "cuda"
        self._neighbours = {}
        for axis in range(3):
            for step in (-1, 1):
                c = list(self.coords)
                c[axis] += step
                self._neighbours[axis, step] = (
                    int(np.ravel_multi_index(c, self.shape))
                    if 0 <= c[axis] < self.shape[axis] else None)

    def neighbour(self, axis: int, step: int) -> Optional[int]:
        """The rank one step (-1 lower, +1 higher) along `axis`, or None
        at the domain's edge."""
        return self._neighbours[axis, step]

    def pinned(self, key, shape, dtype) -> torch.Tensor:
        """The pinned host buffer of `key`, `shape` and `dtype`, made at
        its first use and reused after (one per plane of each level)."""
        full = (key, tuple(shape), dtype)
        buf = self._pinned.get(full)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[full] = buf
        return buf


def rank_device(device: str) -> torch.device:
    """The device of this rank: the CPU, or card LOCAL_RANK modulo the
    number of cards.  Raises when a card is asked for and there is none."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "-device cuda: no CUDA device is available "
            "(pass -device cpu to run on the CPU)"
        )
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_rank_mesh(mesh_shape, rank: int, device: str) -> RankMesh:
    """The rank grid as seen from `rank` (JAX `make_device_mesh`)."""
    shape = tuple(int(m) for m in mesh_shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"mesh_shape must be 3 positive ints: {mesh_shape}")
    if not 0 <= rank < int(np.prod(shape)):
        raise ValueError(f"rank {rank} outside mesh {shape}")
    return RankMesh(shape=shape, rank=rank, device=rank_device(device))


def describe(mesh: RankMesh) -> str:
    """The line rank 0 prints at start."""
    shape = ",".join(str(m) for m in mesh.shape)
    if mesh.staged:
        cards = torch.cuda.device_count()
        return (f"# mesh {shape}: {mesh.world} ranks on {cards} card(s) "
                f"over {BACKEND} (planes staged through host memory)")
    return f"# mesh {shape}: {mesh.world} ranks on the CPU over {BACKEND}"
