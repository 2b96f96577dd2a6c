"""The port's `FusedDriver` (`-fused 1`) against the JAX package's, 17x9x9
nodes, 2 MG levels, rmin 0.16, on the CPU.  The JAX runs take its nodal
path (`operator_impl "xla"`), which compiles in seconds; the port runs
both of its paths, whose math is the same:

- the log lines: the JAX banner and non-iteration lines verbatim, the
  iteration lines in its format and order;
- the trajectory over 3 iterations, and with projection over iterations
  9-11 of a resumed run, where beta continuation moves beta at iteration
  10 and the driver re-projects;
- a JAX fused restart resumed by the port, continuing JAX's trajectory;
- the JAX package's TPU levers (-ksp_chunk, -park_design, -tail_split)
  change nothing in the port's run.

Tolerances as tests/test_torch_fused_step.py's: fx rtol 2e-4; gx, ch and
mnd absolute 1e-4; solver iterations within 1.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.fused_driver import FusedDriver as JaxFusedDriver
from topopt_in_petsc_tpu_torch.__main__ import main
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.fused_driver import FusedDriver

torch.set_num_threads(1)

ARGS = dict(nx=17, ny=9, nz=9, nlvls=2, rmin=0.16, fused=True,
            output_cadence_vtu=False)
FX_RTOL, ABS_TOL = 2e-4, 1e-4

NUM = r"-?[0-9]+\.[0-9]+"
LOG_LINES = [
    re.compile(rf"^State solver:  iter: \d+, rerr\.: {NUM}e[-+]\d\d, "
               rf"time: {NUM}$"),
    re.compile(rf"^It\.: \d+, True fx: {NUM}, Scaled fx: {NUM}, "
               rf"gx\[0\]: {NUM}, ch\.: {NUM}, mnd\.: {NUM}, time: {NUM}$"),
]
STEPS = ("State solver", "It.:")
PORT_PATHS = {"default": {}, "pallas": {"operator_impl": "pallas"}}


def _run(driver_cls, cfg):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hist = driver_cls(cfg).run()
    return hist, buf.getvalue().splitlines()


def _jax(workdir, **kw):
    cfg = JaxConfig(**ARGS, operator_impl="xla", dtype="float32",
                    workdir=str(workdir), **kw)
    cfg.validate()
    return _run(JaxFusedDriver, cfg)


def _port(workdir, **kw):
    return _run(FusedDriver, TopOptConfig(**ARGS, device="cpu",
                                          workdir=str(workdir), **kw))


def _assert_close(h, ref, its):
    for i, j in its:
        assert h["fx"][i] == pytest.approx(ref["fx"][j], rel=FX_RTOL), i
        for k in ("gx", "ch", "mnd"):
            assert abs(h[k][i] - ref[k][j]) <= ABS_TOL, (k, i)
        assert abs(h["iters"][i] - ref["iters"][j]) <= 1


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _jax(tmp_path_factory.mktemp("jax"), maxItr=3)


@pytest.mark.parametrize("path", PORT_PATHS)
def test_fused_driver_matches_jax(jax_run, tmp_path, path):
    (jh, jlog), (ph, plog) = jax_run, _port(tmp_path, maxItr=3,
                                            **PORT_PATHS[path])
    assert len(ph["fx"]) == len(jh["fx"]) == 3
    _assert_close(ph, jh, [(i, i) for i in range(3)])
    assert set(ph) == set(jh)
    assert not any(ph["stalled"])
    # the banner and every non-iteration line verbatim, in order
    for keep in (lambda line: line.startswith("#"),
                 lambda line: not line.startswith(("#", *STEPS))):
        assert [x for x in plog if keep(x)] == [x for x in jlog if keep(x)]
    body = [line for line in plog if line.startswith(STEPS)]
    assert len(body) == 6
    for k, line in enumerate(body):
        assert LOG_LINES[k % 2].match(line), line
    assert [line.split(":")[0] for line in body] == \
        [line.split(":")[0] for line in jlog if line.startswith(STEPS)]


def test_projection_and_beta_continuation_match_jax(tmp_path):
    """The Heaviside projection, and beta continuation: JAX runs 8
    iterations and writes its restart pair; JAX and the port each resume
    it for iterations 9-11, where beta moves 1 -> 2 at iteration 10 and
    both drivers re-project.  (Resumed from one state: with projection a
    difference in the last bit of f32 grows about 3x per iteration, in
    the JAX package against itself too, so a 10-iteration run from
    scratch is no test.)"""
    kw = dict(projectionFilter=True, beta=1.0, eta=0.5)
    _jax(tmp_path, maxItr=8, **kw)
    resume = dict(maxItr=11, restartFileVec=str(tmp_path / "Restart00.npz"),
                  restartFileVecSol=str(tmp_path / "RestartSol00.npz"), **kw)
    jh, jlog = _jax(tmp_path / "jax", **resume)
    ph, plog = _port(tmp_path / "port", **resume)
    beta_lines = [x for x in jlog if x.startswith("Beta has been")]
    assert beta_lines == ["Beta has been increased to: 2.000000"]
    assert [x for x in plog if x.startswith("Beta has been")] == beta_lines
    assert len(ph["fx"]) == len(jh["fx"]) == 3
    _assert_close(ph, jh, [(i, i) for i in range(3)])


def test_port_resumes_jax_fused_restart(jax_run, tmp_path):
    """The JAX fused driver runs 2 iterations and writes its restart pair;
    the port's fused driver resumes it, and its iteration 3 matches JAX's
    uninterrupted iteration 3."""
    jh, _ = jax_run
    _jax(tmp_path, maxItr=2)
    h, log = _port(
        tmp_path / "port", maxItr=3,
        restartFileVec=str(tmp_path / "Restart00.npz"),
        restartFileVecSol=str(tmp_path / "RestartSol00.npz"),
    )
    assert any(line.startswith("# Continue optimization") for line in log)
    assert len(h["fx"]) == 1
    _assert_close(h, jh, [(0, 2)])


def test_tpu_levers_change_nothing(tmp_path):
    """-ksp_chunk, -park_design and -tail_split are accepted no-ops: the
    run is the same, bit for bit."""
    base = ["-nx", "17", "-ny", "9", "-nz", "9", "-nlvls", "2", "-rmin",
            "0.16", "-fused", "1", "-maxItr", "2", "-device", "cpu",
            "-output_cadence_vtu", "0"]
    hist = []
    for extra in ([], ["-ksp_chunk", "8", "-park_design", "1",
                       "-tail_split", "1"]):
        wd = tmp_path / f"run{len(hist)}"
        with contextlib.redirect_stdout(io.StringIO()):
            assert main([*base, *extra, "-workdir", str(wd)]) == 0
        with np.load(os.path.join(wd, "history.npz")) as z:
            hist.append({k: z[k] for k in ("fx", "gx", "ch", "mnd",
                                           "iters")})
    for k in hist[0]:
        np.testing.assert_array_equal(hist[0][k], hist[1][k])
