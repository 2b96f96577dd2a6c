"""Wall-clock timing helpers: the JAX package's `utils/timers.py`.

The reference instruments with manual MPI_Wtime pairs around each outer
iteration (main.cc:59, 105) and each linear solve
(LinearElasticity.cc:187, 219).  Work on a card is queued, so a section
given a tensor (or several) to wait for synchronises the card that
tensor lives on before it stops the clock; a CPU tensor needs no wait.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


def _wait_for(sync) -> None:
    """Block until the work that produces `sync` (a tensor, or a list or
    tuple of them) has run on each card it lives on."""
    tensors = sync if isinstance(sync, (list, tuple)) else [sync]
    for dev in {t.device for t in tensors}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class Timer:
    """Accumulating named timer."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextmanager
    def section(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _wait_for(sync)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(
                f"{name}: total {tot:.3f} s, calls {n}, "
                f"avg {tot / n * 1e3:.2f} ms"
            )
        return "\n".join(lines)


@contextmanager
def timed(label: str, result=None):
    t0 = time.perf_counter()
    yield
    if result is not None:
        _wait_for(result)
    print(f"{label}: {time.perf_counter() - t0:.4f} s")
