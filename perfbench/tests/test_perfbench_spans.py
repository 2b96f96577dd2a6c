"""The span readers (`perfbench/spans.py`, `metrics/*_per_iter.py`) on a
made-up window of two iterations: each stage's graph launch inside its
program span, the flag reads' copies and the driver's scalar read, and
one kernel whose launch no span holds."""

import copy
import json

import pytest

from perfbench import harness, spans, tracing
from perfbench.tests.conftest import ROOT

NEW = ("solve_ms_per_iter", "filter_ms_per_iter", "mma_ms_per_iter",
       "dip_segments_per_iter", "step_idle_ms_per_iter")
# one iteration: (span, launch call, its records' device us)
FLAG = ("fused.flag", "cudaMemcpyAsync", [0.5])
ITERATION = [
    ("fused.pre", "cudaGraphLaunch", [3.0]),
    ("fused.pcg", "cudaGraphLaunch", [2.0, 2.0]), FLAG,
    ("fused.pcg", "cudaGraphLaunch", [2.0, 2.0]), FLAG,
    ("fused.head", "cudaGraphLaunch", [1.0]),
    ("fused.mma_start", "cudaGraphLaunch", [1.5]),
    ("fused.dip", "cudaGraphLaunch", [0.5]), FLAG,
    ("fused.dip", "cudaGraphLaunch", [0.5]), FLAG,
    ("fused.dip", "cudaGraphLaunch", [0.5]), FLAG,
    ("fused.post", "cudaGraphLaunch", [2.5]),
]
SCALARS = [("driver.scalars", "cudaLaunchKernel", [1.0]),
           ("driver.scalars", "cudaMemcpyAsync", [0.5])]
STEP_US = 10.0 * len(ITERATION) + 5.0
STRAY_US = 7.0
STEP = spans.STEP


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1}


def _window():
    host, device = [], []
    corr = iter(range(1, 1000))

    def launch(call, ts, durs):
        c = next(corr)
        host.append({"cat": "cuda_runtime", "name": call, "ts": ts + 1.0,
                     "dur": 1.0, "pid": 1, "tid": 1,
                     "args": {"correlation": c}})
        t = ts + 2.0
        for d in durs:
            cat = "gpu_memcpy" if call == "cudaMemcpyAsync" else "kernel"
            name = ("Memcpy DtoH (Device -> Pinned)" if cat == "gpu_memcpy"
                    else "void at::native::vectorized_elementwise_kernel")
            device.append({"cat": cat, "name": name, "ts": t, "dur": d,
                           "args": {"correlation": c}})
            t += d

    for o in (0.0, 400.0):
        host.append(_span("fused.step", o, STEP_US))
        for i, (name, call, durs) in enumerate(ITERATION):
            ts = o + 1.0 + 10.0 * i
            host.append(_span(name, ts, 10.0))
            launch(call, ts, durs)
            if name == "fused.flag":
                host.append({"cat": "cuda_runtime", "pid": 1, "tid": 1,
                             "name": "cudaStreamSynchronize",
                             "ts": ts + 3.0, "dur": 5.0,
                             "args": {"correlation": next(corr)}})
        t = o + STEP_US + 10.0
        host.append(_span("driver.scalars", t, 30.0))
        for j, (_, call, durs) in enumerate(SCALARS):
            launch(call, t + 1.0 + 10.0 * j, durs)
    launch("cudaLaunchKernel", 300.0, [STRAY_US])  # in no span
    w = tracing.Window(device=device, host=host, wall_s=800e-6, iters=2,
                       span=(0.0, 800.0))
    w.card = "NVIDIA H100 80GB HBM3"
    w.counters = {"solver_iters": [20, 22], "pde_iters": [[], []]}
    return w


def read(name, w):
    return harness.load_reader(name)(w)


def test_each_metric_of_the_spans():
    w = _window()
    assert read("solve_ms_per_iter", w) == pytest.approx(11.0e-3)
    assert read("filter_ms_per_iter", w) == pytest.approx(3.5e-3)
    assert read("mma_ms_per_iter", w) == pytest.approx(3.0e-3)
    assert read("dip_segments_per_iter", w) == 3.0
    # busy inside a step: 11 + 3.5 + 3 us of stages, 5 copies of 0.5 us
    assert read("step_idle_ms_per_iter", w) == pytest.approx(
        (STEP_US - 20.0) * 1e-3)


def test_device_ms_by_span_adds_up_to_the_window():
    w = _window()
    by = spans.device_ms(w)
    assert by["fused.flag"] == pytest.approx(2 * 2.5e-3)
    assert by["driver.scalars"] == pytest.approx(2 * 1.5e-3)
    assert STEP not in by
    total = sum(float(e["dur"]) for e in w.device) * 1e-3
    assert sum(by.values()) == pytest.approx(total)


def test_a_record_of_no_span_counts_nowhere():
    w = _window()
    assert spans.device_ms(w)[None] == pytest.approx(STRAY_US * 1e-3)
    alone = _window()
    alone.device = [e for e in alone.device if e["dur"] != STRAY_US]
    for name in NEW:
        assert read(name, w) == pytest.approx(read(name, alone)), name


def test_nothing_to_read_without_a_step_span():
    w = _window()
    w.host = [e for e in w.host if e["name"] != STEP]
    assert spans.device_ms(w)["fused.pcg"] > 0
    for name in NEW:
        assert read(name, w) is None, name
    bare = _window()
    bare.host = [e for e in bare.host if e.get("cat") != "user_annotation"]
    for name in NEW:
        assert read(name, bare) is None, name


def test_the_spans_move_no_accepted_reader():
    accepted = [m["name"] for m in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["per_layer"]
        if m["name"] not in NEW]
    w = _window()
    bare = copy.deepcopy(w)
    bare.host = [e for e in bare.host if e.get("cat") != "user_annotation"]
    for name in accepted:
        assert read(name, w) == read(name, bare), name
    assert read("launches_per_iter", w) == 10.5
    assert read("syncs_per_iter", w) == 11.0  # 5 syncs and 6 copies back


@pytest.mark.cuda
def test_every_record_of_a_replayed_step_has_its_span(card, tmp_path):
    """On the card, a graph-replayed step's kernels link to their
    `cudaGraphLaunch` and so to its stage's span: no record is left to no
    span, and each stage group owns device time."""
    from topopt_in_petsc_tpu_torch.config import TopOptConfig
    from topopt_in_petsc_tpu_torch.parallel.fused_step import make_fused_step

    step, s = make_fused_step(TopOptConfig(
        nx=17, ny=9, nz=9, nlvls=2, rmin=0.16, device="cuda"))
    for itr in (1, 2, 3):  # iteration 3 captures the graphs
        step(s, itr)

    def run_once():
        for itr in (4, 5):
            step(s, itr)
        return 2

    w = tracing.traced(run_once, str(tmp_path / "trace.json"))
    by = spans.device_ms(w)
    assert None not in by and w.device
    assert set(by) <= {*spans.SOLVE, *spans.FILTER, *spans.MMA,
                       "fused.flag"}
    for group in (spans.SOLVE, spans.FILTER, spans.MMA):
        assert spans.ms_per_iter(w, group) > 0
    assert spans.count_per_iter(w, "fused.dip") >= 1
