"""The per-layer readers' arithmetic on a recorded small window: two
iterations with K1 at two levels, K3, plain kernels, a copy back to the
host, launches and synchronizations."""

import pytest

from perfbench import harness, roofline, tracing

CARD = "NVIDIA H100 80GB HBM3"
GRID_FINE, GRID_COARSE, GRID_K3 = (9, 4, 2), (5, 2, 1), (3, 3, 3)


def _k(name, ts, dur, grid=(1, 1, 1)):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"grid": list(grid)}}


def _h(name, ts, dur=1.0, cat="cuda_runtime"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.fixture
def window():
    device = [
        _k("void hex_operator_kernel<float>(...)", 100.0, 50.0, GRID_FINE),
        _k("hex_operator_kernel", 160.0, 10.0, GRID_COARSE),
        _k("helmholtz_kernel", 170.0, 20.0, GRID_K3),
        _k("void at::native::vectorized_elementwise_kernel<4>", 190.0, 40.0),
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
         "ts": 300.0, "dur": 5.0},
        _k("hex_operator_kernel", 400.0, 50.0, GRID_FINE),
        _k("reduce_kernel", 450.0, 30.0),
    ]
    host = [_h("cudaGraphLaunch", 90.0, 5.0), _h("cudaLaunchKernel", 95.0),
            _h("cudaStreamSynchronize", 231.0, 60.0),
            _h("cudaGraphLaunch", 305.0, 90.0),
            _h("cudaDeviceSynchronize", 481.0, 10.0),
            _h("aten::copy_", 290.0, 20.0, "cpu_op")]
    w = tracing.Window(device=device, host=host, wall_s=500e-6, iters=2,
                       span=(0.0, 500.0))
    w.levels = {"K1": {GRID_FINE: (17, 9, 9), GRID_COARSE: (9, 5, 5)},
                "K3": {GRID_K3: (17, 9, 9)}}
    w.card = CARD
    w.counters = {"solver_iters": [20, 22, 24],
                  "pde_iters": [[3, 4, 5], [4, 4, 4], [5, 5, 5]]}
    return w


def read(name, w):
    return harness.load_reader(name)(w)


def test_counts_per_iteration(window):
    assert read("launches_per_iter", window) == 1.5
    assert read("syncs_per_iter", window) == 1.5  # 2 syncs + 1 read
    assert read("solver_iters_per_solve", window) == 22.0
    assert read("pde_iters_per_iter", window) == 13.0


def test_plain_kernels(window):
    assert read("torch_ops_ms_per_iter", window) == pytest.approx(0.035)


def test_busy_and_idle(window):
    # busy: [100, 150], [160, 230], [300, 305], [400, 480]: 205 us of 500
    assert window.busy_s() == pytest.approx(205e-6)
    assert read("idle_pct", window) == pytest.approx(59.0)


def test_roofline_shares(window):
    fine = roofline.bound_s("K1", (17, 9, 9), CARD)
    coarse = roofline.bound_s("K1", (9, 5, 5), CARD)
    want = 100 * (2 * fine + coarse) / 110e-6
    assert read("k1_roofline_pct", window) == pytest.approx(want)
    k3 = roofline.bound_s("K3", (17, 9, 9), CARD)
    assert read("k3_roofline_pct", window) == pytest.approx(100 * k3 / 20e-6)
    assert read("k1bf16_roofline_pct", window) is None


def test_a_grid_of_no_level_reads_nothing(window):
    window.levels["K1"].pop(GRID_COARSE)
    assert read("k1_roofline_pct", window) is None


def test_no_pde_filter_reads_nothing(window):
    window.counters["pde_iters"] = [[], []]
    assert read("pde_iters_per_iter", window) is None


def test_breakdown(window):
    b = tracing.breakdown(window, top=3)
    assert [n for n, _ in b["device_ops"]] == [
        "hex_operator_kernel", "vectorized_elementwise_kernel",
        "reduce_kernel"]
    assert b["device_ops"][0][1] == pytest.approx(110e-6)
    # gaps: [0,100] [150,160] [230,300] [305,400] [480,500]
    assert [g[1] for g in b["idle_gaps"]] == pytest.approx(
        [100e-6, 95e-6, 70e-6])
    assert b["idle_gaps"][1][0] == "host: cudaGraphLaunch"
    assert b["idle_gaps"][2][0] == "host: cudaStreamSynchronize"
