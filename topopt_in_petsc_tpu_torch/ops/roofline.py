"""The least time an H100 could take for each kernel's work, and the
device time of a kernel as a CUDA graph replays it.

The bound is the larger of the compulsory bytes (each input read once,
each output written once) over the memory rate and the f32 operations
over the f32 peak outside the tensor cores.  Peaks are NVIDIA's published
H100 SXM figures at its 700 W limit.  The operations are those of the
element products the kernels run for a brick's KE (csrc/hex_tile.cuh),
counted as FLOP (an add or a multiply 1, an FMA 2):

* K1 and K4, ``K(E) u``: per element the reflection product, two 8-point
  Walsh-Hadamard transforms of 3 components (2 x 72 adds) and the eight
  3 x 3 blocks (24 multiplies + 48 FMAs), and the E scaling (24
  multiplies); per node the sum of 8 corner contributions (21 adds).  The
  plain 24 x 24 product would be 576 FMAs per element.
* K1-bf16, K1 on bf16 storage (half the bytes), its column body: per
  element the y-z half of the transform on the one node plane it loads
  (24 adds; the other half is carried from the last element), the x
  butterfly (24 adds), the 45 entries that a brick's blocks can make
  nonzero (21 multiplies + 24 FMAs), the E scaling of the 21 rows they
  fill (21 multiplies), the inverse x butterfly (18 adds: three pairs
  have an empty row), the carried ox = 1 forces added (12 adds) and one
  inverse y-z half (24 adds); per node the sum of its 4 columns (9
  adds).
* K2, ``u_e . (u_e @ KE)``: per element one transform (72 adds), the
  blocks (24 multiplies + 48 FMAs) and the 24-term dot (24 FMAs), in
  place of 600 FMAs.
* K3, ``K(E) u`` for one component: per element the scalar reflection
  product, two 8-point transforms (2 x 24 adds) and the eight modes'
  multiplies, and the E scaling (8 multiplies); per node the sum of 8
  corner terms (7 adds).  The plain 8 x 8 product would be 64 FMAs per
  element.

Every kernel is bound by its bytes at every grid size (K1-bf16 at 257^3:
0.0708 ms against 0.0504 for its operations).
"""

from __future__ import annotations

import statistics

import torch

H100_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12

# (bytes per s, f32 FLOP per s) of each card these peaks are known for,
# by its `torch.cuda.get_device_name`
CARDS = {"NVIDIA H100 80GB HBM3": (H100_BYTES_PER_S, H100_F32_FLOP_PER_S)}


def card_peaks(card: str) -> tuple[float, float]:
    """(bytes per s, f32 FLOP per s) of the card named `card`; raises on a
    card whose peaks are not in `CARDS`."""
    try:
        return CARDS[card]
    except KeyError:
        raise ValueError(f"no peaks known for the card {card!r}; known: "
                         f"{', '.join(CARDS)}") from None


def _counts(nn):
    nx, ny, nz = nn
    return nx * ny * nz, (nx - 1) * (ny - 1) * (nz - 1)


def work(kernel: str, nn) -> tuple[float, float]:
    """(bytes, FLOP) of one call of `kernel` ("K1".."K4", f32 storage, or
    "K1-bf16", K1 on bf16 storage) on an `nn` node grid."""
    nnode, nelem = _counts(nn)
    if kernel in ("K1", "K4"):  # u, E read; out written
        return 4.0 * (6 * nnode + nelem), (144 + 120 + 24) * nelem + 21 * nnode
    if kernel == "K1-bf16":
        return (2.0 * (6 * nnode + nelem),
                (24 + 24 + 69 + 21 + 18 + 12 + 24) * nelem + 9 * nnode)
    if kernel == "K2":  # u read, q written
        return 4.0 * (3 * nnode + nelem), (72 + 120 + 48) * nelem
    if kernel == "K3":  # dof 1: u, E read, out written
        return 4.0 * (2 * nnode + nelem), (48 + 8 + 8) * nelem + 7 * nnode
    raise ValueError(f"unknown kernel {kernel!r}")


def bound_ms(kernel: str, nn) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations") of one call."""
    nbytes, flops = work(kernel, nn)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def graph_ms(fns, n: int, reps: int = 15) -> list:
    """Median device ms per call of each of `fns`: CUDA-event times of the
    replay of a CUDA graph of n back-to-back calls (no host launch cost),
    over n; the graphs are replayed in turns, the order reversed every
    other round, after one warm-up replay each."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for f in fns:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                f()
        graphs.append(g)
    for g in graphs:
        g.replay()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for rep in range(reps):
        order = range(len(fns)) if rep % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graphs[i].replay()
            b.record()
            torch.cuda.synchronize()
            times[i].append(a.elapsed_time(b) / n)
    return [statistics.median(t) for t in times]
