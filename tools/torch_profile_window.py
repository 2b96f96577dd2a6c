#!/usr/bin/env python3
"""How often chip_smoke.py's profile check misses a kernel record, and
which record: chip_smoke.py's torch.profiler window (`_window`, which its
phases 15, 17, 19 and 20 read through `_profile`) over one steady fused
iteration at 65x33x33, repeated from the same state.

    python3 tools/torch_profile_window.py [--runs 55] [--paths a,b,...]

Paths (`PATHS`): `fgmres-nodal` and `galerkin`, phase 19's two profiles
(`-fused 1` with `-ksp_type fgmres -operator_impl pallas`, and with
`-coarse_op galerkin_octant`), and `default` (`-fused 1`, the path that
phase 15 profiles at 257^3).  For each path the driver runs iterations
1-4 (the third captures the CUDA graphs), its state is kept, and then
each window restores that state and profiles `run(5)`, the driver's
iteration 5 (eager pre-loop filter, the step's graph replays and its
eager stages, the logged scalars), as phase 19 does: every window makes
the same launches.  Per window: whether the device's records of K1-K4
equal the growth of the wrappers' launch counts (the check of
`_profile`); the device's records by kind (kernels, copies, fills);
how many of the 1 + PAD_BURST records of the opening and of the closing
pad (chip_smoke.py `_pad`) the trace lost; the device clock against the
host's (`clocks`); and, against the window with
the most records, for each host call whose device records fall short, the call
(a graph launch, or an eager kernel launch, copy or fill), its place
among the window's calls that make device work (first, last, inside the
n-th graph replay, or an eager call before, between or after the
replays), the records it lacks, and its host time from the window's
first host event.

Prints one short JSON line per window with a miss or a shortfall, and
one summary line per path; writes every window's full line
to chiprun_out/torch_profile_window.jsonl.  Exits 1 without a card, 2 if
the windows of a path do not make the same launches.
"""

import argparse
import contextlib
import difflib
import io
import json
import os
import sys
import time
from collections import Counter

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

PATHS = {
    "fgmres-nodal": ["-ksp_type", "fgmres", "-operator_impl", "pallas"],
    "galerkin": ["-coarse_op", "galerkin_octant"],
    "default": [],
}
HOST_CATS = ("cuda_runtime", "cuda_driver")
OUT = os.path.join(REPO, "chiprun_out", "torch_profile_window.jsonl")


def _corr(e):
    return e.get("args", {}).get("correlation")


def _makes_work(name):
    return name in chip_smoke._LAUNCH_CALLS or name.startswith(
        ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset"))


def window_calls(events):
    """The window's host calls that make device work (launches, graph
    launches, copies, fills) in host order, each (name, host us from the
    window's first host event, Counter of its device records' names), and
    the device records without such a call."""
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and e.get("ph") == "X" and _makes_work(e["name"])),
                  key=lambda e: e["ts"])
    dev = [e for e in events if e.get("cat") in chip_smoke._DEVICE_CATS]
    t0 = min((e["ts"] for e in events if e.get("ph") == "X"
              and e.get("cat") not in chip_smoke._DEVICE_CATS),
             default=0.0)
    by_corr = {}
    for e in dev:
        by_corr.setdefault(_corr(e), Counter())[
            chip_smoke._kernel_label(e["name"])] += 1
    calls = [(e["name"], round(e["ts"] - t0, 1),
              by_corr.get(_corr(e), Counter())) for e in host]
    seen = {_corr(e) for e in host}
    orphans = sum((n for c, n in by_corr.items() if c not in seen),
                  Counter())
    return calls, orphans


def _place(i, calls):
    """Where call `i` lies among the window's calls that make device
    work."""
    graphs = [j for j, (n, _, _) in enumerate(calls)
              if n == "cudaGraphLaunch"]
    if i == 0:
        where = "first call"
    elif i == len(calls) - 1:
        where = "last call"
    elif i in graphs:
        where = f"graph replay {graphs.index(i) + 1} of {len(graphs)}"
    elif not graphs or i < graphs[0]:
        where = "eager, before the first replay"
    elif i > graphs[-1]:
        where = "eager, after the last replay"
    else:
        where = "eager, between replays"
    return f"{where} (call {i + 1} of {len(calls)})"


def shortfalls(calls, ref):
    """The calls whose records fall short of the reference window's,
    matched call by call (the windows make the same calls; a call
    missing from the trace is reported as lacking all its records)."""
    names = [n for n, _, _ in calls]
    ref_names = [n for n, _, _ in ref]
    out = []
    ops = difflib.SequenceMatcher(None, ref_names, names,
                                  autojunk=False).get_opcodes()
    for tag, i1, i2, j1, j2 in ops:
        pairs = (zip(range(i1, i2), range(j1, j2)) if tag == "equal"
                 else ((i, None) for i in range(i1, i2)))
        for i, j in pairs:
            want = ref[i][2]
            got = calls[j][2] if j is not None else Counter()
            lack = want - got
            if lack:
                out.append({"call": ref[i][0], "place": _place(i, ref),
                            "in_trace": j is not None,
                            "host_us": calls[j][1] if j is not None
                            else None, "lacks": dict(lack),
                            "records": sum(want.values())})
    return out


def clocks(events):
    """Device against host clock in the trace, in us: the first device
    record's start less the call's span start, the span's end less the
    last device record's end (a device record cannot start before the
    host call that made it, nor end after the synchronization that
    waited for it), and the least and median start of an eager call's
    first record less the call's host time."""
    span = next(e for e in events if e["name"] == chip_smoke.WINDOW_SPAN
                and e.get("cat") != "gpu_user_annotation")
    dev = [e for e in events if e.get("cat") in chip_smoke._DEVICE_CATS]
    host = {_corr(e): e["ts"] for e in events
            if e.get("cat") in HOST_CATS and _makes_work(e["name"])
            and e["name"] != "cudaGraphLaunch"}
    first = {}
    for e in dev:
        c = _corr(e)
        if c in host:
            first[c] = min(first.get(c, e["ts"]), e["ts"])
    delays = sorted(first[c] - host[c] for c in first)
    return {
        "first_record_after_span_start_us": round(
            min(e["ts"] for e in dev) - span["ts"], 1) if dev else None,
        "span_end_after_last_record_us": round(
            span["ts"] + span["dur"]
            - max(e["ts"] + e.get("dur", 0.0) for e in dev), 1)
        if dev else None,
        "eager_start_delay_us": [round(delays[0], 1),
                                 round(delays[len(delays) // 2], 1)]
        if delays else None,
    }


def by_kind(events):
    return dict(Counter(e["cat"] for e in events
                        if e.get("cat") in chip_smoke._DEVICE_CATS))


def pads_lost(events, pads):
    """How many of the 1 + PAD_BURST records of the opening pad (those
    before the call's first device record) and of the closing pad (after
    its last) the trace lost."""
    dev = [e["ts"] for e in events
           if e.get("cat") in chip_smoke._DEVICE_CATS]
    first, last, want = min(dev), max(dev), 1 + chip_smoke.PAD_BURST
    return {"opening_pad_lost": want - sum(e["ts"] < first for e in pads),
            "closing_pad_lost": want - sum(e["ts"] > last for e in pads)}


def run_path(name, args, runs, out, card=None):
    d = chip_smoke._fused_driver([], 5, args)
    d.run(4)
    torch.cuda.synchronize()
    saved = {f: getattr(d.state, f).clone() for f in d.state._fields}

    def once():
        for f, t in saved.items():
            getattr(d.state, f).copy_(t)
        d.itr = 4
        with contextlib.redirect_stdout(io.StringIO()):
            d.run(5)

    first_counted, windows = None, []
    t_start = time.perf_counter()
    for r in range(runs):
        ev, counted, wall, _, pads = chip_smoke._window(once)
        if first_counted is None:
            first_counted = counted
        elif counted != first_counted:
            print(f"{name}: window {r} counted {counted}, window 0 "
                  f"{first_counted}: the windows differ", flush=True)
            return 2
        on_device = chip_smoke._kernel_runs(chip_smoke._device_kernels(ev))
        calls, orphans = window_calls(ev)
        line = {"path": name, "window": r,
                "miss": counted != on_device, "counted": counted,
                "on_device": on_device, "records": by_kind(ev),
                "orphan_records": dict(orphans), **pads_lost(ev, pads),
                **clocks(ev), "wall_s": round(wall, 4)}
        windows.append((line, calls))
    # the reference: the window with the most records (none is lost there)
    ref_line, ref = max(windows, key=lambda w: sum(w[0]["records"].values()))
    lacks, places, short_kinds = Counter(), Counter(), Counter()
    for line, calls in windows:
        short = {k: v - line["records"].get(k, 0)
                 for k, v in ref_line["records"].items()}
        if line["miss"]:
            line["missing"] = {k: line["counted"][k] - line["on_device"][k]
                               for k, v in line["counted"].items()
                               if v != line["on_device"][k]}
            lacks.update(line["missing"])
        if any(short.values()):
            line["short_of_reference"] = short
            short_kinds.update({k: v for k, v in short.items() if v})
            line["shortfalls"] = shortfalls(calls, ref)
            for f in line["shortfalls"]:
                places[f["place"].split(" (")[0]] += 1
        out.write(json.dumps(line) + "\n")
        if line["miss"] or "shortfalls" in line:
            print(json.dumps({k: line.get(k) for k in (
                "path", "window", "miss", "missing",
                "short_of_reference", "opening_pad_lost", "closing_pad_lost",
                "first_record_after_span_start_us",
                "span_end_after_last_record_us")}), flush=True)
    summary = {"card": card, "path": name, "runs": runs,
               "misses": sum(w[0]["miss"] for w in windows),
               "missing_by_kernel": dict(lacks),
               "records_short_by_kind": dict(short_kinds),
               "shortfall_places": dict(places),
               # per pad: windows that lost any of its records, the most
               # lost in one window, and the records lost in all
               **{f"{side}_pad_lost": [
                   sum(w[0][f"{side}_pad_lost"] > 0 for w in windows),
                   max(w[0][f"{side}_pad_lost"] for w in windows),
                   sum(w[0][f"{side}_pad_lost"] for w in windows)]
                  for side in ("opening", "closing")},
               "windows_short": sum("shortfalls" in w[0] for w in windows),
               "counted": first_counted,
               "reference_window": [ref_line["window"],
                                    ref_line["records"]],
               "seconds": round(time.perf_counter() - t_start, 1)}
    print(json.dumps(summary), flush=True)
    del d
    torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=55)
    p.add_argument("--paths", default=",".join(PATHS))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_window: no CUDA device available",
              file=sys.stderr)
        return 1
    import topopt_in_petsc_tpu_torch.config  # noqa: F401  (sets TF32 off)

    card = chip_smoke.phase_environment()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    rc = 0
    with open(OUT, "w") as out:
        for name in a.paths.split(","):
            rc = max(rc, run_path(name, PATHS[name], a.runs, out, card))
    return rc


if __name__ == "__main__":
    sys.exit(main())
