"""One run of one cell of the benchmark (`run.py` is its command line).

The cell, its configuration, its traffic, its limits and its metrics are
found by name: the cell and the metrics in `BENCHMARK.json`, the
configuration in the file its entry names, the traffic in
`traffic/<traffic>.json`, the limits in `limits/<cell>.json` and each
per-layer metric's reader in `metrics/<metric>.py`.

A run:

1. makes the starting design (`design.run_design`: the traffic's seeded
   design, mirrored in y for an odd seed) and writes it to a file under
   TMPDIR;
2. builds the program's fused driver with the configuration's and the
   traffic's flags, the design loaded by `-restart 1 -restartFileVec
   FILE -onlyLoadDesign 1` and no output written;
3. runs iterations 1-3 as set-up (iteration 3 captures the CUDA graphs);
4. runs whole iterations for the given seconds, each the driver's step
   and its one scalar read, as `FusedDriver.run` drives them; with
   tracing, the first two iterations that start after half of the
   window run inside a profiler window;
5. judges one of the window's first iterations, drawn from the seed
   (`check`).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import random
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

from perfbench import check, readers, roofline, tracing
from perfbench.design import run_design, write_design

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
SETUP_ITERS = 3  # iteration 3 captures the graphs
CHECK_AT = 3  # the judged iteration is one of the window's first 3
# the traced window holds the first PROFILE_ITERS iterations that start
# once half of the measured window has passed
PROFILE_ITERS = 2
JAX_NAMES = ("jax", "jaxlib", "flax", "topopt_in_petsc_tpu")


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_spec(name: str) -> dict:
    """Everything a run of the cell `name` needs, found by name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = _by_name(bench["workloads"], name, "workload")
    conf = _by_name(bench["configs"], cell["config"], "config")
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())

    def here(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if here(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in reported and here(m)]
    return {"chips": cell["chips"],
            "flags": {**config["flags"], **traffic["flags"]},
            "traffic": traffic, "limits": limits,
            "end_to_end": e2e, "per_layer": layer}


def load_reader(metric: str):
    """The `read` function of `metrics/<metric>.py`."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def to_argv(flags: dict) -> list:
    return [w for k, v in flags.items() for w in (f"-{k}", str(v))]


def jax_modules(names=None) -> list:
    """The top-level names among `names` (default: the loaded modules)
    that are one of JAX_NAMES, compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(JAX_NAMES))


class Record(NamedTuple):
    solver_iters: int
    failed: bool
    pde_iters: list
    seconds: float  # host seconds of the iteration, its scalar read included


class Loop:
    """The body of `FusedDriver.run`'s loop without its log lines and
    writers: the step, the driver's one scalar read and, under
    -projectionFilter 1, beta continuation with its re-projection."""

    def __init__(self, drv):
        self.drv = drv
        self.itr = 0
        self.records = []

    def begin(self) -> None:
        """The design filtered with the current beta before iteration 1."""
        s = self.drv.state
        xTilde, xPhys = self.drv.step.project(s.x, s.beta)
        s.xTilde.copy_(xTilde)
        s.xPhys.copy_(xPhys)

    def iterate(self) -> None:
        from topopt_in_petsc_tpu_torch.opt.filters import (
            DesignFilter,
            smooth_projection,
        )

        drv, cfg, s = self.drv, self.drv.cfg, self.drv.state
        t0 = time.perf_counter()
        self.itr += 1
        drv.itr = self.itr
        drv.step(s, self.itr)
        fx, _, ch, _, gx0, beta0, iters, relres, _, pde = drv._scalars()
        if cfg.projectionFilter:
            beta, _ = DesignFilter.increase_beta(beta0, cfg.betaFinal, gx0,
                                                 self.itr, ch)
            if beta != beta0:
                s.beta.fill_(beta)
                s.xPhys.copy_(smooth_projection(s.xTilde, s.beta,
                                                drv.step.eta))
        stalled = iters >= cfg.ksp_maxit and relres > cfg.ksp_rtol
        self.records.append(Record(
            iters, stalled or not math.isfinite(fx) or
            not math.isfinite(relres), pde, time.perf_counter() - t0))


def _launches() -> dict:
    """The program's launch count of each kernel entry point (graph replays
    included), to hold the trace's kernel runs against."""
    from topopt_in_petsc_tpu_torch.ops.cuda_build import KERNELS

    return {k.symbol: k.launches for k in KERNELS}


def _levels(flags: dict) -> dict:
    """Launch grid -> node grid of K1, K1-bf16 and K3 at each level of the
    state's and the PDE filter's hierarchies; a grid two levels share is
    left out."""
    from topopt_in_petsc_tpu_torch.ops.blocked_hex import hex_operator_grid
    from topopt_in_petsc_tpu_torch.ops.nodal_hex import helmholtz_grid

    def hierarchy(n):
        nn = (flags["nx"], flags["ny"], flags["nz"])
        out = [nn]
        for _ in range(n - 1):
            nn = tuple((k - 1) // 2 + 1 for k in nn)
            out.append(nn)
        return out

    def table(query, grids):
        by = {}
        for nn in grids:
            by.setdefault(tuple(query(nn)), []).append(nn)
        return {g: v[0] for g, v in by.items() if len(v) == 1}

    state = hierarchy(flags["nlvls"])
    out = {"K1": table(hex_operator_grid, state),
           "K1-bf16": table(lambda nn: hex_operator_grid(nn, torch.bfloat16),
                            state)}
    if flags.get("filter") == 2:
        out["K3"] = table(helmholtz_grid,
                          hierarchy(flags.get("pde_nlvls", 3)))
    return out


def _print_kernels(w) -> None:
    """Each operator kernel's runs in the trace and, per level, their
    device ms beside the bytes bound and, for the record, the operations'
    bound (67 TFLOP/s of f32), on standard error."""
    for kernel in readers.KERNEL_NAMES:
        runs = readers.runs_of(w, kernel)
        by = {}
        for e in runs:
            nn = w.levels.get(kernel, {}).get(
                tuple(e.get("args", {}).get("grid", ())))
            n, ms = by.get(nn, (0, 0.0))
            by[nn] = (n + 1, ms + float(e["dur"]) * 1e-3)
        for nn, (n, ms) in by.items():
            line = f"{kernel} at {nn}: {n} runs, {ms:.4f} ms"
            if nn is not None:
                t_bytes = roofline.bound_s(kernel, nn, w.card) * 1e3
                t_ops = (roofline.work_flop(kernel, nn)
                         / roofline.H100_F32_FLOP_PER_S * 1e3)
                line += (f"; bound per run {t_bytes:.4f} ms (bytes), "
                         f"{t_ops:.4f} ms (operations)")
            print(line, file=sys.stderr)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             control: bool = False) -> dict:
    """One run of a cell (`cell_spec`); returns the result's fields.  With
    `control`, the judged iteration's outputs are the control's
    (`check.Reference.control_outputs`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        with contextlib.redirect_stdout(sys.stderr):
            return _run(spec, seed, seconds, trace, device, t_start,
                        control, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(spec, seed, seconds, trace, device, t_start, control, tmp):
    from topopt_in_petsc_tpu_torch.config import TopOptConfig
    from topopt_in_petsc_tpu_torch.fused_driver import FusedDriver

    flags = spec["flags"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    ne = (flags["nx"] - 1, flags["ny"] - 1, flags["nz"] - 1)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    x_seed = run_design(ne, flags["volfrac"], seed, spec["traffic"],
                        device=dev)
    design = os.path.join(tmp, "design.npz")
    write_design(design, x_seed)
    marks.append(("design", time.perf_counter()))
    cfg = TopOptConfig.from_args(to_argv(flags) + [
        "-device", device, "-workdir", os.path.join(tmp, "work"),
        "-output_cadence_vtu", "0", "-output_dat", "0", "-restart", "1",
        "-restartFileVec", design, "-onlyLoadDesign", "1"])
    drv = FusedDriver(cfg)
    os.remove(design)
    marks.append(("driver", time.perf_counter()))
    s = drv.state
    loop = Loop(drv)
    loop.begin()
    start = {k: getattr(s, k).to("cpu", copy=True) for k in ("x", "xPhys")}
    snap_in = check.Snapshot(s, check.INPUTS)
    snap_out = check.Snapshot(s, check.OUTPUTS)
    marks.append(("snapshots", time.perf_counter()))
    for i in range(SETUP_ITERS):
        loop.iterate()
        if cuda:
            torch.cuda.synchronize()
        marks.append((f"iteration {i + 1}", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    print("set-up s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])),
        file=sys.stderr)
    judged = 1 + random.Random(seed).randrange(CHECK_AT)
    window = None
    n = 0

    def one():
        nonlocal n
        n += 1
        if n == judged:
            snap_in.take(s)
        loop.iterate()
        if n == judged:
            snap_out.take(s)

    def profiled():
        before = _launches()
        for _ in range(PROFILE_ITERS):
            one()
        grown = {k: v - before[k] for k, v in _launches().items()}
        print(f"kernel launches in the traced window: {grown}",
              file=sys.stderr)
        return PROFILE_ITERS

    trace_path = os.path.join(tmp, "trace.json")
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        if trace and window is None and \
                time.perf_counter() >= t0 + 0.5 * seconds:
            window = tracing.traced(profiled, trace_path)
        else:
            one()
        if time.perf_counter() >= deadline:
            break
    wall = time.perf_counter() - t0
    counted = loop.records[SETUP_ITERS:]
    print("window: " + json.dumps({
        "s": [round(r.seconds, 4) for r in counted],
        "solver_iters": [r.solver_iters for r in counted],
        "pde_iters": [sum(r.pde_iters) for r in counted]}), file=sys.stderr)
    # the judged and the traced iterations, where the window closed first
    while n < judged:
        one()
    if trace and window is None:
        window = tracing.traced(profiled, trace_path)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    metrics = {}
    units = {m["name"]: m["unit"] for m in
             spec["end_to_end"] + spec["per_layer"]}
    values = {"s_per_iter": wall / len(counted),
              "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    if not trace:
        metrics = {m["name"]: values[m["name"]] for m in spec["end_to_end"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {}
    if trace:
        window.counters = {
            "solver_iters": [r.solver_iters for r in counted],
            "pde_iters": [r.pde_iters for r in counted]}
        window.levels = _levels(flags)
        window.card = device_info["kind"]
        for m in spec["per_layer"]:
            v = load_reader(m["name"])(window)
            if v is not None:
                metrics[m["name"]] = v
        _print_kernels(window)
        device_info["busy_s"] = window.busy_s()
        device_info["window_s"] = window.wall_s
        out["breakdown"] = tracing.breakdown(window)
    failed = sum(r.failed for r in counted)
    inp = dict(snap_in.bufs)
    outp = dict(snap_out.bufs)
    del loop, drv, s, window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = check.Reference(flags, dev)
    if control:
        outp = ref.control_outputs(inp, outp)
        start = dict(zip(("x", "xPhys"), ref.control_start(x_seed)))
    numbers = {"start_gap": ref.start_gap(x_seed, start["x"],
                                          start["xPhys"]),
               **ref.judge(inp, outp)}
    limits = spec["limits"]
    return {
        "correct": check.verdict(numbers, limits),
        "attempted": len(counted), "failed": failed,
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in metrics.items()},
        "device": device_info, **out,
        "compared": {k: {"value": v, "limit": limits.get(k)}
                     for k, v in numbers.items()},
    }
