"""The starting design of a run, made from its seed, and the file that hands
it to the program through the design-load route users take
(`-restart 1 -restartFileVec FILE -onlyLoadDesign 1`).

`seeded_design` takes correctly rounded elementwise float64 arithmetic
alone, so every machine makes the same bits from a seed, in numpy or,
given a device, in PyTorch there (the divisor a tensor, so that the
division is not turned into a product by a reciprocal).  The file is an
`.npz` holding the design `x` and the program's restart checksum of it
(a Fletcher-style sum of its bytes), the only members that a design load
reads.
"""

from __future__ import annotations

import numpy as np
import torch

_MOD = 0xFFFFFFFF
_CHUNK = 1 << 22
_ROW = 1 << 12


def seeded_design(ne, volfrac: float, seed: int, amplitude: float,
                  device=None):
    """(ex, ey, ez) float64 numpy design: uniform noise u in [-0.5, 0.5)
    on the elements, smoothed by four passes of a periodic 3-point mean
    along each axis, then volfrac (1 + amplitude u) clipped to
    [0.05, 0.95]; the smoothing runs on `device` when one is given."""
    u = np.random.default_rng(seed).random(tuple(ne)) - 0.5
    if device is None:
        for _ in range(4):
            for ax in range(3):
                u = (np.roll(u, 1, ax) + u + np.roll(u, -1, ax)) / 3.0
        return np.clip(volfrac * (1.0 + amplitude * u), 0.05, 0.95)
    u = torch.as_tensor(u, device=device)
    three = torch.tensor(3.0, dtype=torch.float64, device=device)
    for _ in range(4):
        for ax in range(3):
            u = torch.div(torch.roll(u, 1, ax) + u + torch.roll(u, -1, ax),
                          three)
    return torch.clamp(volfrac * (1.0 + amplitude * u), 0.05, 0.95).cpu() \
        .numpy()


def run_design(ne, volfrac: float, seed: int, traffic: dict, device=None):
    """The starting design of a run with `seed`: the traffic's own seeded
    design (`design_seed`, `amplitude`), mirrored across the mid-plane
    y = const when `seed` is odd.  The cantilever is symmetric in y (the
    wall, the line load and the domain), so both images take the same
    optimization path, mirrored, and every seed the same work."""
    x = seeded_design(ne, volfrac, traffic["design_seed"],
                      traffic["amplitude"], device=device)
    return np.ascontiguousarray(x[:, ::-1, :]) if seed % 2 else x


def checksum64(data) -> int:
    """a = 1 + sum of the bytes, b = sum of the running a, both modulo
    2^32 - 1, as (b << 32) | a; b = n + n S - T with S the sum of the
    bytes and T the sum of i c_i, taken by chunks as row and column sums
    of a table of the bytes."""
    v = np.frombuffer(data, dtype=np.uint8)
    n = v.size
    S = T = 0
    for s in range(0, n, _CHUNK):
        c = v[s:s + _CHUNK]
        m = c.size - c.size % _ROW
        table = c[:m].reshape(-1, _ROW)
        rows = table.sum(axis=1, dtype=np.uint32).astype(np.int64)
        cols = table.sum(axis=0, dtype=np.uint32).astype(np.int64)
        tail = c[m:].astype(np.int64)
        cs = int(rows.sum()) + int(tail.sum())
        S += cs
        T += (s * cs + _ROW * int(np.arange(rows.size) @ rows)
              + int(np.arange(_ROW) @ cols)
              + int(np.arange(m, c.size) @ tail))
    return (((n + n * S - T) % _MOD) << 32) | ((1 + S) % _MOD)


def write_design(path: str, x) -> None:
    """The design file at `path` (an `.npz`): x and its checksum."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    with open(path, "wb") as f:
        np.savez(f, x=x, checksum=np.uint64(checksum64(x)))
