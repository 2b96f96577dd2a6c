"""The port's production campaign, `tools/torch_run_campaign256.sh`, against
the JAX package's (`tools/run_campaign256.sh`'s flags through its CLI),
on the CPU at a size it runs in seconds: 17x9x9 nodes, `-nlvls 2 -rmin
0.16 -fused 1 -dtype float64 -maxItr 21 -output_dat 1 -output_cadence_vtu
0`, restarts on.  21 iterations cross the campaign's cadences: the `.dat`
at iterations 1-10, 20 and the final dump (22), restarts at 10, 20 and
the final one, flipping Restart00 and Restart01
(`chip_smoke.campaign_cadence`, which smoke phase 28 holds the card's
257^3 run to).

The port runs through the script itself, its size, `-device cpu` and
`-dtype float64` after the campaign's flags, `GOLDEN=` the JAX run's
history, and `import jax` failing in every process it starts; so the log,
`summary.txt` (tools/summarize_run.py) and `golden_gate.txt`
(tools/compare_history.py) are the script's.

- histories: fx rtol 1e-6, gx absolute 1e-8, ch 1e-6 and mnd 1e-7, the
  same solver iterations.  The mesh tests' f64 bars (fx 1e-8, gx and ch
  1e-10) hold at iteration 1 only: the coarse CG stops at its tolerance,
  so each package's order of sums moves fx by ~4e-9 there, and the
  movlim-bound updates of iterations 14-21 amplify it (measured, one
  torch thread: fx 2.3e-7 at iteration 18, gx 3.6e-9 at 19, ch 5.7e-7
  at 20, mnd 1.1e-8 at 18);
- the same files, the `.dat`'s datasets (the port's index, the JAX
  `read_dat`), their fields within 2e-5 of each field's largest value
  (measured 1.2e-6 up to iteration 10, 5.8e-6 in x at the final dump),
  and each restart file's iteration;
- a resume continues the port's run exactly (rtol 1e-12, as
  tests/test_torch_resume.py's fused resume): of the restart the cadence
  wrote last (iteration 20, against the campaign's iteration 21) and of
  the final one (iteration 21, against a straight run's iteration 22);
- the script's exit code is the gate's, and it refuses the JAX
  campaign's directory;
- `tools/torch_campaign_probe.py`: its `# memory` lines at the iterations
  asked for, and its f32-rounded element matrices, restored after.
"""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.driver import run_topopt as jax_run_topopt
from topopt_in_petsc_tpu.io import mpiio_dat as jdat
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import run_topopt
from topopt_in_petsc_tpu_torch.io.mpiio_dat import index_dat

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tools", "torch_run_campaign256.sh")
PROBE = os.path.join(REPO, "tools", "torch_campaign_probe.py")
N = 21
SIZE = ["-nx", "17", "-ny", "9", "-nz", "9", "-nlvls", "2", "-rmin", "0.16",
        "-dtype", "float64"]
CAMPAIGN = ["-fused", "1", "-output_dat", "1", "-output_cadence_vtu", "0"]
BARS = {"fx": 1e-6, "gx": 1e-8, "ch": 1e-6, "mnd": 1e-7}
# a .dat field against the JAX one's, of its largest value
FIELD_BAR = 2e-5
SCRIPT_FILES = {"run.log", "summary.txt", "golden_gate.txt"}


def _script(workdir, *flags, env=(), shim=None):
    """Run the campaign script into `workdir` with `flags` after its own;
    with `shim`, a directory whose `jax` package fails to import comes
    first on every process's path."""
    e = {**os.environ, "OMP_NUM_THREADS": "1", **dict(env)}
    if shim is not None:
        e["PYTHONPATH"] = os.pathsep.join(
            [str(shim), *filter(None, [e.get("PYTHONPATH")])])
    return subprocess.run(["bash", SCRIPT, str(workdir), *flags], env=e,
                          capture_output=True, text=True, timeout=600)


def _history(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jax_campaign(tmp_path_factory):
    """The JAX package's campaign, once per module: its workdir and
    history (saved as its CLI saves it)."""
    work = tmp_path_factory.mktemp("jax")
    with contextlib.redirect_stdout(io.StringIO()):
        h = jax_run_topopt(JaxConfig.from_args(
            [*SIZE, *CAMPAIGN, "-maxItr", str(N), "-workdir", str(work)]))
    np.savez(work / "history.npz", **{k: np.asarray(v) for k, v in h.items()})
    return work, _history(work / "history.npz")


@pytest.fixture(scope="module")
def port_campaign(jax_campaign, tmp_path_factory):
    """The port's campaign through the script, gated against the JAX
    history: (workdir, completed process, history)."""
    shim = tmp_path_factory.mktemp("shim")
    (shim / "jax").mkdir()
    (shim / "jax" / "__init__.py").write_text(
        "raise ImportError('the campaign must not import jax')\n")
    work = tmp_path_factory.mktemp("port")
    done = _script(work, "-device", "cpu", *SIZE, "-maxItr", str(N),
                   env={"GOLDEN": str(jax_campaign[0] / "history.npz")},
                   shim=shim)
    return work, done, _history(work / "history.npz")


def test_script_runs_the_port_and_passes_its_gate(port_campaign):
    work, done, _ = port_campaign
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-2000:]
    gate = (work / "golden_gate.txt").read_text().splitlines()
    assert gate[-1] == "PASS"
    log = (work / "run.log").read_text()
    assert "# Number of nodes: (-nx,-ny,-nz):        (17,9,9)" in log
    assert log.count("It.: ") == N


def test_histories_match_jax(jax_campaign, port_campaign):
    ref, h = jax_campaign[1], port_campaign[2]
    assert len(h["fx"]) == len(ref["fx"]) == N
    np.testing.assert_allclose(h["fx"], ref["fx"], rtol=BARS["fx"])
    for k in ("gx", "ch", "mnd"):
        np.testing.assert_allclose(h[k], ref[k], rtol=0, atol=BARS[k])
    np.testing.assert_array_equal(h["iters"], ref["iters"])
    assert not h["stalled"].any() and not ref["stalled"].any()


def test_same_files_as_jax_and_the_cadence(jax_campaign, port_campaign):
    port = set(os.listdir(port_campaign[0])) - SCRIPT_FILES
    assert port == set(os.listdir(jax_campaign[0])) == {
        "output_00000.dat", "history.npz", "Restart00.npz", "Restart01.npz",
        "RestartSol00.npz", "RestartSol01.npz"}


def test_dat_datasets_match_jax_and_the_cadence(jax_campaign, port_campaign):
    want = chip_smoke.campaign_cadence(N)[0]
    assert want == [*range(1, 11), 20, 22]
    port = str(port_campaign[0] / "output_00000.dat")
    ref = jdat.read_dat(str(jax_campaign[0] / "output_00000.dat"))
    assert [st["itr"] for st in index_dat(port).steps] == want
    assert [st["itr"] for st in ref["steps"]] == want
    # the same fields, through the JAX reader (the .dat stores f32)
    for got, st in zip(jdat.read_dat(port)["steps"], ref["steps"]):
        for kind in ("point_fields", "cell_fields"):
            for name, v in st[kind].items():
                np.testing.assert_allclose(got[kind][name], v, rtol=0,
                                           atol=FIELD_BAR * np.abs(v).max())


@pytest.mark.parametrize("name", ["Restart00.npz", "Restart01.npz"])
def test_restart_files_hold_the_flips_iteration(jax_campaign, port_campaign,
                                                name):
    writes = chip_smoke.campaign_cadence(N)[1]
    assert writes == [("Restart00.npz", 10), ("Restart01.npz", 20),
                      ("Restart00.npz", 21)]
    got = []
    for work in (port_campaign[0], jax_campaign[0]):
        with np.load(work / name) as z:
            got.append(int(z["itr"]))
    assert got == [dict(writes)[name]] * 2


@pytest.mark.parametrize("which", ["cadence", "final"])
def test_resume_continues_the_port_run(port_campaign, tmp_path, which):
    work, _, campaign = port_campaign
    if which == "cadence":
        # Restart01 (iteration 20) against the campaign's iteration 21
        k, stop, ref = "01", N, campaign
    else:
        # Restart00, the final write (iteration 21), against a straight
        # run's iteration 22
        k, stop = "00", N + 1
        with contextlib.redirect_stdout(io.StringIO()):
            ref = run_topopt(TopOptConfig.from_args(
                ["-device", "cpu", *SIZE, *CAMPAIGN, "-maxItr", str(stop),
                 "-output_dat", "0", "-restart", "0", "-workdir",
                 str(tmp_path / "straight")]))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        h = run_topopt(TopOptConfig.from_args(
            ["-device", "cpu", *SIZE, *CAMPAIGN, "-maxItr", str(stop),
             "-output_dat", "0",
             "-restartFileVec", str(work / f"Restart{k}.npz"),
             "-restartFileVecSol", str(work / f"RestartSol{k}.npz"),
             "-workdir", str(tmp_path / "resumed")]))
    assert (f"# Continue optimization from file: {work / f'Restart{k}.npz'}"
            in log.getvalue().splitlines())
    assert len(h["fx"]) == 1
    for key in ("fx", "gx", "ch", "mnd"):
        np.testing.assert_allclose(h[key][0], ref[key][stop - 1],
                                   rtol=1e-12)
    assert h["iters"][0] == ref["iters"][stop - 1]


def test_summary_parses_every_iteration(port_campaign):
    work, _, h = port_campaign
    lines = (work / "summary.txt").read_text().splitlines()
    assert lines[0] == f"iterations: {N}"
    assert lines[2].endswith(", stalls 0")
    assert lines[2].startswith(
        f"solver iterations: median {int(np.sort(h['iters'])[N // 2])}, "
        f"min {int(h['iters'].min())}, max {int(h['iters'].max())}")
    assert lines[3].startswith(f"fx: first {h['fx'][0]:.4f} -> last "
                               f"{h['fx'][-1]:.4f}")


def test_script_exits_with_the_gates_code(tmp_path):
    """Against the default reference (the JAX package's 257^3 campaign on
    the CPU) a 17x9x9 run fails the gate: the script exits 1, as
    compare_history.py does; the TPU golden's gap is printed on a line of
    its own."""
    done = _script(tmp_path, "-device", "cpu", *SIZE, "-maxItr", "1")
    assert done.returncode == 1, done.stdout[-2000:] + done.stderr[-2000:]
    gate = (tmp_path / "golden_gate.txt").read_text().splitlines()
    assert "docs/jax_cpu_history_257x257x257_campaign.npz: 3 iters" in gate[0]
    assert gate[-1] == "FAIL (fx rel diff > 0.001)"
    assert re.search(r"^TPU golden \(not gated; golden_history_257x257x257"
                     r"\.npz\): fx max rel diff \S+ at iter 1 ",
                     done.stdout, re.M), done.stdout[-2000:]
    assert (tmp_path / "summary.txt").read_text().startswith("iterations: 1")


def test_script_refuses_the_jax_campaign_dir():
    jax_dir = os.path.join(REPO, "runs", "prod256")
    before = sorted(os.listdir(jax_dir))
    for target in (jax_dir, os.path.join(jax_dir, "sub")):
        done = _script(target, "-device", "cpu", *SIZE, "-maxItr", "1")
        assert done.returncode == 2
        assert "holds the JAX campaign" in done.stderr
    assert sorted(os.listdir(jax_dir)) == before


def test_probe_prints_memory_lines(tmp_path):
    """The probe runs the CLI with one `# memory` line (host RSS on the
    CPU) after each iteration asked for, and the CLI's own history."""
    done = subprocess.run(
        [sys.executable, PROBE, "--memory-at", "1,3", "-device", "cpu",
         *SIZE, *CAMPAIGN, "-output_dat", "0", "-maxItr", "3", "-workdir",
         str(tmp_path)], env={**os.environ, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    lines = re.findall(r"^# memory it\. (\d+): host RSS (\d+) B$",
                       done.stderr, re.M)
    assert [int(i) for i, _ in lines] == [1, 3]
    assert min(int(b) for _, b in lines) > 0
    assert len(_history(tmp_path / "history.npz")["fx"]) == 3


def test_probe_rounds_element_matrices_to_f32():
    spec = importlib.util.spec_from_file_location("probe", PROBE)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    from topopt_in_petsc_tpu_torch.models import elasticity

    exact = elasticity.hex8_stiffness(0.5, 0.25, 0.25, 0.3)
    with probe.f32_element_matrices():
        rounded = elasticity.hex8_stiffness(0.5, 0.25, 0.25, 0.3)
    assert rounded.dtype == np.float64
    np.testing.assert_array_equal(rounded,
                                  exact.astype(np.float32).astype(np.float64))
    assert not np.array_equal(rounded, exact)
    np.testing.assert_array_equal(
        elasticity.hex8_stiffness(0.5, 0.25, 0.25, 0.3), exact)
