"""The fused step's spans (utils/spans.py) under a CPU profiler, 17x9x9
nodes, 2 MG levels, rmin 0.16:

- one steady iteration (the third) records `fused.step` once, and inside
  it one `fused.<stage>` span per run of a stage and one `fused.flag` per
  read of a loop's flag, in the order the step ran them (counted by
  wrapping the stage functions and the flag read): the stages in
  `_stages` order, `fused.close` under `-ksp_type fgmres`, the PDE
  filter's stages under `-filter 2`, one `fused.pcg`, `fused.pde` or
  `fused.dip` span per segment;
- with no profiler recording, an iteration enters no `record_function`
  (the same counting `record_function` counts every span under one);
- `span` is one shared no-op context while no profiler records.

The driver's spans in a `-profile_dir` trace: test_torch_utils.py,
`test_profile_dir_writes_a_trace_and_changes_no_number`.
"""

import contextlib
import itertools
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.parallel.fused_step import (
    FusedStep,
    make_fused_step,
)
from topopt_in_petsc_tpu_torch.utils.spans import span

torch.set_num_threads(1)

ARGS = dict(nx=17, ny=9, nz=9, nlvls=2, rmin=0.16, device="cpu")
SOLVE = ["pre", "pcg"]
MMA = ["mma_start", "dip"]
PDE = ["pde_start", "pde", "pde_finish"]
# path -> (options, the stages of an iteration, repeats merged)
PATHS = {
    "default": ({}, [*SOLVE, "head", *MMA, "post"]),
    "fgmres": ({"ksp_type": "fgmres"},
               [*SOLVE, "close", "head", *MMA, "post"]),
    "filter2": ({"filter": 2, "pde_nlvls": 2},
                [*SOLVE, "head", *PDE, *PDE, *MMA, "post_x", *PDE,
                 "post"]),
}


def _steady(opts):
    """A fused step and its state after iterations 1 and 2."""
    step, state = make_fused_step(TopOptConfig(**ARGS, **opts))
    for itr in (1, 2):
        state = step(state, itr)
    return step, state


@contextlib.contextmanager
def _calls(monkeypatch):
    """The names of the stages the step runs and "flag" for each read of
    a loop's flag, in order."""
    calls = []
    stages, more = FusedStep._stages, FusedStep._more

    def counted(st):
        def fn():
            calls.append(st.name)
            return st.fn()
        return st._replace(fn=fn)

    monkeypatch.setattr(FusedStep, "_stages", lambda self, *a: [
        counted(st) for st in stages(self, *a)])

    def read(self, flag):
        calls.append("flag")
        return more(self, flag)

    monkeypatch.setattr(FusedStep, "_more", read)
    yield calls


def _spans(prof, tmp_path):
    """The recorded spans as (name, start, end), by start, read from the
    profile's Chrome trace (as the benchmark reads its window)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith(("fused.", "driver."))),
                  key=lambda s: s[1])


@pytest.mark.parametrize("path", PATHS)
def test_steady_iteration_spans(path, monkeypatch, tmp_path):
    opts, stages = PATHS[path]
    step, state = _steady(opts)
    with _calls(monkeypatch) as calls:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, 3)
    spans = _spans(prof, tmp_path)
    (name, lo, hi), inner = spans[0], spans[1:]
    assert name == "fused.step"
    assert all(lo <= a and b <= hi for _, a, b in inner)
    # direct children of fused.step: none holds another
    assert all(b0 <= a1 for (_, _, b0), (_, a1, _) in zip(inner, inner[1:]))
    assert [n.removeprefix("fused.") for n, _, _ in inner] == calls
    ran = [n for n in calls if n != "flag"]
    assert [k for k, _ in itertools.groupby(ran)] == stages
    for loop in ("pcg", "pde", "dip"):
        if loop in stages:
            # a loop's flag is read after each of its segments
            segments = ran.count(loop)
            assert segments >= 1
            after = [b for a, b in zip(calls, calls[1:]) if a == loop]
            assert after == ["flag"] * segments


class _Counting(torch.profiler.record_function):
    entered = 0

    def __enter__(self):
        type(self).entered += 1
        return super().__enter__()


def test_no_span_without_a_profiler(monkeypatch, tmp_path):
    step, state = _steady({})
    monkeypatch.setattr(_Counting, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    step(state, 3)
    assert _Counting.entered == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, 4)
    assert _Counting.entered == len(_spans(prof, tmp_path)) > 0


def test_span_is_a_shared_no_op_without_a_profiler():
    assert span("fused.pre") is span("fused.post")
    with span("fused.pre") as inside:
        assert inside is None
    with profile(activities=[ProfilerActivity.CPU]):
        live = span("fused.pre")
    assert isinstance(live, torch.profiler.record_function)
    assert live.name == "fused.pre"
