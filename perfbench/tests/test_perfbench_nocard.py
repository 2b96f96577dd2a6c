"""The measurement path needs a card: without one, and without the
program beside it, `run.py` exits non-zero and prints no result."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench.tests.conftest import ROOT

ARGS = ["--workload", "c257.fused", "--seed", str(2 ** 31 + 9),
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", *ARGS], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": "/tmp",
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_benchmark_alone_is_no_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "compared"
    assert r["correct"] and r["device"]["platform"] == "gpu"
