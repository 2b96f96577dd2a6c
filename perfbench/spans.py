"""Device time by the program's own spans, for the per-layer metrics that
read them (`metrics/*_per_iter.py`).

The port opens a host span around each stage of its fused step, each
read of a loop's flag and the driver's scalar read while a profiler
records (`fused.step`, `fused.<stage>`, `fused.flag`, `driver.*`:
`topopt_in_petsc_tpu_torch/utils/spans.py`).  A record of the card (a
kernel, copy or fill) carries the correlation of the host call that
launched it, a replayed graph's kernels that of its `cudaGraphLaunch`;
it belongs to the innermost program span, on the launching thread, that
holds that call.  A record whose launch no span holds belongs to no span.
Every reader returns None where the window holds no `fused.step` span
(a program without spans).
"""

from __future__ import annotations

from perfbench import readers

PREFIXES = ("fused.", "driver.")
STEP = "fused.step"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the stages of each group; under -filter 1 the design update x(lambda)
# runs in `fused.post`, so the filter's group holds it there
SOLVE = ("fused.pre", "fused.pcg", "fused.close")
FILTER = ("fused.head", "fused.pde_start", "fused.pde", "fused.pde_finish",
          "fused.post")
MMA = ("fused.mma_start", "fused.dip", "fused.post_x")


def _thread(e) -> tuple:
    return e.get("pid"), e.get("tid")


def program_spans(w) -> list:
    """The program's spans in the window's host records."""
    return [e for e in w.host if e.get("cat") == "user_annotation"
            and e["name"].startswith(PREFIXES)]


def owner_of(w) -> dict:
    """The correlation of each host launch call -> the name of the
    innermost program span on its thread that holds it."""
    by_thread = {}
    for s in program_spans(w):
        by_thread.setdefault(_thread(s), []).append(s)
    out = {}
    for e in w.host:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") not in LAUNCH_CATS or corr is None:
            continue
        a, b = e["ts"], e["ts"] + e.get("dur", 0.0)
        around = [s for s in by_thread.get(_thread(e), ())
                  if s["ts"] <= a and b <= s["ts"] + s["dur"]]
        if around:
            out[corr] = min(around, key=lambda s: s["dur"])["name"]
    return out


def device_ms(w) -> dict:
    """Device milliseconds of the window's records by the span that owns
    them; those of no span under None."""
    owner = owner_of(w)
    out = {}
    for e in w.device:
        name = owner.get(e.get("args", {}).get("correlation"))
        out[name] = out.get(name, 0.0) + float(e.get("dur", 0.0)) * 1e-3
    return out


def has_steps(w) -> bool:
    return any(s["name"] == STEP for s in program_spans(w))


def ms_per_iter(w, names):
    """Device ms per iteration of the records the spans `names` own."""
    if not has_steps(w):
        return None
    by = device_ms(w)
    return readers.per_iter(sum(by.get(n, 0.0) for n in names), w)


def count_per_iter(w, name):
    """The spans `name` per iteration."""
    if not has_steps(w):
        return None
    n = sum(s["name"] == name for s in program_spans(w))
    return readers.per_iter(n, w)


def idle_ms_in(w, name):
    """The card's idle milliseconds inside the spans `name`, per
    iteration: each span's length less its overlap with the card's busy
    intervals."""
    if not has_steps(w):
        return None
    busy = w.busy_intervals()
    idle = 0.0
    for s in program_spans(w):
        if s["name"] != name:
            continue
        lo, hi = s["ts"], s["ts"] + s["dur"]
        idle += (hi - lo) - sum(max(0.0, min(b, hi) - max(a, lo))
                                for a, b in busy)
    return readers.per_iter(idle * 1e-3, w)
