"""Arithmetic that the per-layer metrics (`metrics/<name>.py`) share.

Each reader takes a `tracing.Window` and returns a number, or None where
the window holds nothing for it to read; the harness then leaves the
metric out of the result.
"""

from __future__ import annotations

from perfbench import roofline

# each operator kernel's device function
KERNEL_NAMES = {
    "K1": "hex_operator_kernel",
    "K1-bf16": "hex_operator_bf16_kernel",
    "K2": "quadform_kernel",
    "K3": "helmholtz_kernel",
    "K4": "nodal_hex_kernel",
}


def runs_of(w, kernel: str) -> list:
    """The card's runs of `kernel` in the window."""
    name = KERNEL_NAMES[kernel]
    return [e for e in w.kernels() if name in e["name"]]


def roofline_pct(w, kernel: str):
    """Sum over the runs of `kernel` of the least time its level's work
    takes (`roofline.bound_s`, the level told by the run's launch grid),
    over the sum of the runs' device time, in %.  None without runs, or
    where a run's launch grid names no level."""
    runs = runs_of(w, kernel)
    grids = w.levels.get(kernel, {})
    if not runs:
        return None
    bound = took = 0.0
    for e in runs:
        nn = grids.get(tuple(e.get("args", {}).get("grid", ())))
        if nn is None:
            return None
        bound += roofline.bound_s(kernel, nn, w.card)
        took += float(e["dur"]) * 1e-6
    return 100.0 * bound / took


def per_iter(count: float, w):
    return count / w.iters
