"""The torchrun launch of `-mesh_shape`: the port's counterpart of the JAX
package's `tests/test_multihost.py`, whose 2-process job runs the
`SpmdDriver` with every output on, then a resume and the blocked engine.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m topopt_in_petsc_tpu_torch -device cpu -nx 17 -ny 9 -nz 9 \\
        -nlvls 2 -rmin 0.16 -mesh_shape 2,1,1 ...

Each rank is a process of torchrun's (parallel/multihost.py
`join_torchrun`), against the same flags run by the CLI, which spawns its
ranks itself.  2 ranks, 17x9x9 nodes, 2 MG levels, each launch a
subprocess under its own timeout.

- float64 with every output on (`.vtu` at the default cadence, `.dat`,
  restart): the history equals the spawn launch's bit for bit, and so does
  every file written; rank 0 alone writes them and prints the log;
- a torchrun resume from that restart to `-maxItr 3` against an
  uninterrupted 3-iteration torchrun run: fx rtol 1e-9, gx and ch atol
  1e-10, the same solver iterations (tests/test_torch_spmd_restart.py's
  bars);
- the f32 resident route (`-operator_impl blocked`, K1's plain version on
  the CPU) under torchrun equals the spawn launch bit for bit;
- a launch whose WORLD_SIZE differs from the mesh's positions fails with
  `join_torchrun`'s ValueError;
- the rendezvous environment of a launch on one node, and of one over
  several nodes;
- `tools/torch_bin2vtu.py` on the mesh's `.dat` writes the bytes of the
  mesh's final `.vtu`.

On a card (`cuda` marker; skipped without one) the torchrun launch at
17x9x9 equals the spawn launch there, and both ranks launch K1 and K2.
Run it on a GPU machine with
    python -m pytest --noconftest -m cuda tests/test_torch_spmd_torchrun.py
"""

import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu_torch.io.mpiio_dat import read_dat
from topopt_in_petsc_tpu_torch.parallel.multihost import local_launch_env

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m", "topopt_in_petsc_tpu_torch"]
SPAWN = [sys.executable, "-m", "topopt_in_petsc_tpu_torch"]
GRID = ["-nx", "17", "-ny", "9", "-nz", "9", "-nlvls", "2", "-rmin", "0.16",
        "-mesh_shape", "2,1,1"]
CPU = ["-device", "cpu", *GRID]
F64 = [*CPU, "-dtype", "float64"]
QUIET = ["-output_cadence_vtu", "0", "-restart", "0"]
TIMEOUT = 300
# the ranks share the launch's output, and a C++ warning may still lack its
# newline when another rank writes a line, so lines are searched for
RANK_LINE = re.compile(r"# rank (\d+) launches (\{.*?\}) comm")
OUTPUTS = {"output_00001.vtu", "output_00002.vtu", "output_00003.vtu",
           "output_00000.dat", "Restart00.npz", "RestartSol00.npz"}
KEYS = ("fx", "gx", "ch", "mnd", "iters", "stalled")


def _launch(cmd, workdir):
    """(exit code, output lines) of `cmd ... -workdir workdir`, run from
    the repository under TIMEOUT.  On the timeout torchrun is sent SIGTERM,
    on which it stops its ranks (they run in sessions of their own), and
    the test fails."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([*cmd, "-workdir", str(workdir)], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        finally:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        pytest.fail(f"{cmd} ran past {TIMEOUT} s:\n{out[-4000:]}")
    return proc.returncode, out.splitlines()


def _history(workdir):
    with np.load(os.path.join(workdir, "history.npz")) as h:
        return {k: h[k] for k in h.files}


def _run(cmd, workdir):
    rc, lines = _launch(cmd, workdir)
    assert rc == 0, "\n".join(lines[-80:])
    return _history(workdir), lines


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (history, output lines, workdir), each launch made once, at
    its first use."""
    tmp = tmp_path_factory.mktemp("torchrun")
    first = tmp / "torchrun"
    launches = {
        "torchrun": [*TORCHRUN, *F64, "-maxItr", "2", "-output_dat", "1"],
        "spawn": [*SPAWN, *F64, "-maxItr", "2", "-output_dat", "1"],
        "resume": [*TORCHRUN, *F64, "-maxItr", "3", "-output_cadence_vtu",
                   "0", "-restartFileVec", str(first / "Restart00.npz"),
                   "-restartFileVecSol", str(first / "RestartSol00.npz")],
        "whole": [*TORCHRUN, *F64, "-maxItr", "3", *QUIET],
        "blocked torchrun": [*TORCHRUN, *CPU, "-operator_impl", "blocked",
                             "-maxItr", "2", *QUIET],
        "blocked spawn": [*SPAWN, *CPU, "-operator_impl", "blocked",
                          "-maxItr", "2", *QUIET],
    }
    cache = {}

    def get(name):
        if name not in cache:
            if name == "resume":
                get("torchrun")
            workdir = tmp / name.replace(" ", "_")
            cache[name] = (*_run(launches[name], workdir), workdir)
        return cache[name]

    return get


def _count(lines, text):
    return sum(text in line for line in lines)


def _launches(lines):
    return {int(m.group(1)): json.loads(m.group(2))
            for m in map(RANK_LINE.search, lines) if m}


def _equal(h, ref):
    for k in KEYS:
        np.testing.assert_array_equal(h[k], ref[k], err_msg=k)


def test_torchrun_equals_spawn_bit_for_bit(runs):
    h, _, wd = runs("torchrun")
    ref, _, ref_wd = runs("spawn")
    assert len(h["fx"]) == 2
    _equal(h, ref)
    assert set(os.listdir(wd)) == set(os.listdir(ref_wd))
    for name in sorted(OUTPUTS):
        with open(wd / name, "rb") as f, open(ref_wd / name, "rb") as g:
            assert f.read() == g.read(), name


def test_rank_zero_alone_writes_and_prints(runs):
    _, lines, wd = runs("torchrun")
    # iterations 1-2 and the final dump (iteration 3), one restart pair
    assert set(os.listdir(wd)) == OUTPUTS | {"history.npz"}
    dat = read_dat(str(wd / "output_00000.dat"))
    assert [s["itr"] for s in dat["steps"]] == [1, 2, 3]
    with np.load(wd / "Restart00.npz") as r:
        assert int(r["itr"]) == 2
        x = r["x"]
    assert x.shape == (16, 8, 8)
    np.testing.assert_array_equal(dat["steps"][-1]["cell_fields"]["x"],
                                  x.astype(np.float32).ravel())
    assert _count(lines, "# mesh 2,1,1: 2 ranks on the CPU over gloo") == 1
    assert _count(lines, "# Number of nodes") == 1
    assert _count(lines, "It.: ") == 2
    assert sorted(_launches(lines)) == [0, 1]


def test_torchrun_resume_continues_the_run(runs):
    h, lines, _ = runs("resume")
    first, _, wd = runs("torchrun")
    whole, _, _ = runs("whole")
    assert _count(lines, "# Continue optimization from file: "
                  f"{wd / 'Restart00.npz'}") == 1
    assert len(h["fx"]) == 1
    _equal({k: whole[k][:2] for k in KEYS}, first)
    np.testing.assert_allclose(h["fx"], whole["fx"][2:], rtol=1e-9)
    np.testing.assert_allclose(h["gx"], whole["gx"][2:], atol=1e-10)
    np.testing.assert_allclose(h["ch"], whole["ch"][2:], atol=1e-10)
    np.testing.assert_array_equal(h["iters"], whole["iters"][2:])


def test_blocked_route_under_torchrun_equals_spawn(runs):
    h, _, _ = runs("blocked torchrun")
    ref, _, _ = runs("blocked spawn")
    assert len(h["fx"]) == 2 and np.isfinite(h["fx"]).all()
    _equal(h, ref)


def test_world_size_must_match_the_mesh(tmp_path):
    rc, lines = _launch([*TORCHRUN, *CPU, "-mesh_shape", "2,2,1",
                         "-maxItr", "1", *QUIET], tmp_path)
    assert rc != 0
    assert ("ValueError: -mesh_shape (2, 2, 1) has 4 positions but the "
            "launch has WORLD_SIZE=2") in lines


@pytest.mark.parametrize("nodes", [1, 2])
def test_rendezvous_environment(monkeypatch, nodes):
    """One node: the store at localhost and gloo on the loopback interface
    (a name set by the environment kept); several nodes: as given."""
    monkeypatch.setenv("WORLD_SIZE", str(2 * nodes))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "node0.cluster")
    monkeypatch.delenv("GLOO_SOCKET_IFNAME", raising=False)
    local_launch_env()
    if nodes == 1:
        assert os.environ["MASTER_ADDR"] == "localhost"
        assert os.environ["GLOO_SOCKET_IFNAME"] == "lo"
        monkeypatch.setenv("GLOO_SOCKET_IFNAME", "eth1")
        local_launch_env()
        assert os.environ["GLOO_SOCKET_IFNAME"] == "eth1"
    else:
        assert os.environ["MASTER_ADDR"] == "node0.cluster"
        assert "GLOO_SOCKET_IFNAME" not in os.environ


def test_tool_writes_the_mesh_vtu(runs, tmp_path):
    _, _, wd = runs("torchrun")
    tool = os.path.join(REPO, "tools", "torch_bin2vtu.py")
    p = subprocess.run([sys.executable, tool, "2",
                        str(wd / "output_00000.dat")], cwd=tmp_path,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert p.returncode == 0, p.stderr[-4000:]
    assert p.stdout == "wrote output_00002.vtu\n"
    with open(tmp_path / "output_00002.vtu", "rb") as f, \
            open(wd / "output_00003.vtu", "rb") as g:
        assert f.read() == g.read()


# -- on the card ------------------------------------------------------------ #

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
def test_torchrun_on_the_card_equals_spawn(card, tmp_path):
    flags = [*GRID, "-maxItr", "2", *QUIET]
    h, lines = _run([*TORCHRUN, *flags], tmp_path / "torchrun")
    ref, ref_lines = _run([*SPAWN, *flags], tmp_path / "spawn")
    assert _count(lines, "card(s) over gloo") == 1
    _equal(h, ref)
    for launch in (lines, ref_lines):
        counts = _launches(launch)
        assert sorted(counts) == [0, 1], [line for line in launch
                                          if "# rank" in line]
        for c in counts.values():
            assert c["K1"] > 0 and c["K2"] > 0, counts
