"""A torch.profiler window over part of a run on the card, and what the
per-layer metrics read from it.

A profiler window on the card loses device records at its edges, counted
in records and not in time: up to a few thousand after it opens and at
times up to about 1,600 before it closes.  So the window opens and closes
with a pad, a ~20 ms spin kernel, `PAD_BURST` one-cycle spin kernels and
a synchronization, and the pads' records are left out.  Host records are
kept from inside the window's own span only.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import torch

PAD_CYCLES = 40_000_000
PAD_BURST = 10_000
PAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's device function
SPAN = "perfbench window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaGraphLaunch")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


def _pad() -> None:
    torch.cuda._sleep(PAD_CYCLES)
    for _ in range(PAD_BURST):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


@dataclass
class Window:
    """The records of one traced window: `device` the kernels, copies and
    fills the card ran, `host` the host's records inside the window's
    span, `wall_s` the span's length on the trace's clock, `iters` the
    iterations it held; the harness fills in `counters` (the program's
    counters over the whole measured window), `levels` (launch grid ->
    node grid of each operator kernel) and `card`."""

    device: list
    host: list
    wall_s: float
    iters: int
    counters: dict = field(default_factory=dict)
    levels: dict = field(default_factory=dict)
    card: str = ""
    span: tuple = (0.0, 0.0)  # the window's span on the trace's clock, us

    def kernels(self):
        return [e for e in self.device if e.get("cat") == "kernel"]

    def busy_s(self) -> float:
        """Seconds in which the card ran something: the union of its
        records' intervals."""
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def busy_intervals(self):
        spans = sorted((e["ts"], e["ts"] + e.get("dur", 0.0))
                       for e in self.device)
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out


def traced(run_once, path: str) -> Window:
    """Run `run_once()` (which returns the number of iterations it ran)
    inside one profiler window; the trace goes through `path` and is
    deleted once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad()
        with record_function(SPAN):
            iters = run_once()
            torch.cuda.synchronize()
        _pad()
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f).get("traceEvents", [])
                      if "name" in e and "ts" in e]
    finally:
        if os.path.exists(path):
            os.remove(path)
    spans = [e for e in events if e["name"] == SPAN
             and e.get("cat") in HOST_CATS]
    if len(spans) != 1:
        raise RuntimeError(f"{len(spans)} spans {SPAN!r} in the trace")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and PAD_KERNEL not in e["name"]]
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e is not spans[0] and lo <= float(e["ts"]) <= hi]
    return Window(device=device, host=host, wall_s=(hi - lo) * 1e-6,
                  iters=iters, span=(lo, hi))


def _label(name: str) -> str:
    """A kernel's name without namespaces and argument list, at most 120
    characters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "at::", "c10::", "std::"):
        name = name.replace(junk, "")
    return name.split("(")[0].split("<")[0][:120]


def breakdown(w: Window, top: int = 10) -> dict:
    """The `top` device operations by seconds, and the `top` longest idle
    gaps of the card inside the window, each named by the innermost host
    record that spans its middle."""
    by = {}
    for e in w.device:
        k = _label(e["name"])
        by[k] = by.get(k, 0.0) + float(e.get("dur", 0.0)) * 1e-6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = w.span
    edges = [lo]
    for a, b in w.busy_intervals():
        edges += [a, b]
    edges.append(hi)
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        around = [e for e in w.host
                  if e["ts"] <= mid <= e["ts"] + e.get("dur", 0.0)]
        inner = min(around, key=lambda e: e.get("dur", 0.0), default=None)
        name = f"host: {inner['name'][:100]}" if inner else "host: none"
        named.append([name, (b - a) * 1e-6])
    return {"device_ops": [list(kv) for kv in ops], "idle_gaps": named}
