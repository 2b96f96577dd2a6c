"""Named host spans around the fused step's stages and the driver's
host work, for a profiler's trace.

`span(name)` is a `torch.profiler.record_function(name)` while a
profiler records (the benchmark's traced window, or `-profile_dir`), and
a shared no-op context otherwise: an unrecorded `record_function` costs
~12 us per enter and exit against ~0.2 us for the check, and each stage
boundary sits in the card's idle after a flag read.  Whether a span is
live is decided when `span` is called, so its exit always matches its
entry.

On a card, each kernel, copy or fill the card runs carries the
correlation of the host call that launched it (a graph's kernels that of
its `cudaGraphLaunch`), so the innermost span that holds that call owns
its device time.  The names:

- `fused.step`: one `FusedStep.__call__`, the parent of all below;
- `fused.<stage>`: one run of a stage (eager or a graph replay), one per
  segment for a loop stage: `pre`, `pcg`, `close` (FGMRES), `head`,
  `pde_start`, `pde`, `pde_finish` (`-filter 2`), `mma_start`, `dip`,
  `post_x` (`-filter 2`), `post`;
- `fused.flag`: one read of a loop's flag by the host;
- `driver.scalars`, `driver.beta`, `driver.outputs`, `driver.restart`:
  `FusedDriver`'s scalar read, beta re-projection and writers.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._autograd import _profiler_enabled

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the span `name` while a profiler records."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
