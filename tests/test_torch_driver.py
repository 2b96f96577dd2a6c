"""The whole slice, port vs JAX package: the port's `Driver` against the
JAX package's split `Driver`, 17x9x9 nodes, 2 MG levels, 3 iterations,
on each path of the port:
  - default: density filter with a 3^3 stencil, the resident solve (JAX
    `operator_impl "blocked"`, Pallas in interpret mode);
  - filter2: the Helmholtz PDE filter over the resident solve (JAX
    `operator_impl "blocked"`, `filter 2`);
  - pallas: the nodal solve (JAX `operator_impl "xla"`, the same nodal
    math in plain XLA);
then restart files carried across the two packages in both directions.

Tolerances, from the measured gap (about 3e-5 relative in fx over these 3
iterations, f32 fields with sums in another order): fx rtol 2e-4; gx, ch
and mnd absolute 1e-4; solver iterations within 1.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.driver import Driver as JaxDriver
from topopt_in_petsc_tpu.io.restart import RestartManager as JaxRestart
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import Driver

torch.set_num_threads(1)

ARGS = dict(nx=17, ny=9, nz=9, nlvls=2, rmin=0.16, output_cadence_vtu=False)
FX_RTOL, ABS_TOL = 2e-4, 1e-4

NUM = r"-?[0-9]+\.[0-9]+"
LOG_LINES = [
    re.compile(rf"^State solver:  iter: \d+, rerr\.: {NUM}e[-+]\d\d, "
               rf"time: {NUM}$"),
    re.compile(rf"^It\.: \d+, True fx: {NUM}, Scaled fx: {NUM}, "
               rf"gx\[0\]: {NUM}, ch\.: {NUM}, mnd\.: {NUM}, time: {NUM}$"),
]


def _run(driver_cls, cfg):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hist = driver_cls(cfg).run()
    return hist, buf.getvalue().splitlines()


# path -> (the port's options, the JAX package's options)
PATHS = {
    "default": ({}, {}),
    "filter2": ({"filter": 2}, {"filter": 2}),
    "pallas": ({"operator_impl": "pallas"}, {"operator_impl": "xla"}),
}


def _jax(workdir, **kw):
    kw.setdefault("operator_impl", "blocked")
    cfg = JaxConfig(**ARGS, workdir=str(workdir), **kw)
    cfg.validate()
    return _run(JaxDriver, cfg)


def _port(workdir, **kw):
    cfg = TopOptConfig(**ARGS, device="cpu", workdir=str(workdir), **kw)
    return _run(Driver, cfg)


def _assert_close(h, ref, its):
    for i, j in its:
        assert h["fx"][i] == pytest.approx(ref["fx"][j], rel=FX_RTOL)
        for k in ("gx", "ch", "mnd"):
            assert abs(h[k][i] - ref[k][j]) <= ABS_TOL, (k, i)
        assert abs(h["iters"][i] - ref["iters"][j]) <= 1


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jdir, pdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    return _jax(jdir, maxItr=3), _port(pdir, maxItr=3), pdir


@pytest.fixture(scope="module")
def path_runs(runs, tmp_path_factory):
    """path -> ((JAX history, log), (port history, log)), each run once."""
    cache = {"default": runs[:2]}

    def get(path):
        if path not in cache:
            port_kw, jax_kw = PATHS[path]
            cache[path] = (
                _jax(tmp_path_factory.mktemp(f"jax_{path}"), maxItr=3,
                     **jax_kw),
                _port(tmp_path_factory.mktemp(f"port_{path}"), maxItr=3,
                      **port_kw),
            )
        return cache[path]

    return get


@pytest.mark.parametrize("path", PATHS)
def test_slice_history_matches_jax(path_runs, path):
    (jh, _), (ph, _) = path_runs(path)
    assert len(ph["fx"]) == len(jh["fx"]) == 3
    _assert_close(ph, jh, [(i, i) for i in range(3)])
    assert not any(ph["stalled"])


@pytest.mark.parametrize("path", PATHS)
def test_log_lines_match_jax_format(path_runs, path):
    (_, jlog), (_, plog) = path_runs(path)
    banner = [line for line in jlog if line.startswith("#")]
    assert [line for line in plog if line.startswith("#")] == banner
    # lines outside the iteration log ("Done setting up the PDEFilter")
    # are the JAX package's, in its order
    steps = ("State solver", "It.:")
    assert [line for line in plog if not line.startswith(("#", *steps))] \
        == [line for line in jlog if not line.startswith(("#", *steps))]
    body = [line for line in plog if line.startswith(steps)]
    assert len(body) == 6
    for k, line in enumerate(body):
        assert LOG_LINES[k % 2].match(line), line
    jbody = [line for line in jlog if line.startswith(steps)]
    assert [line.split(":")[0] for line in body] == \
        [line.split(":")[0] for line in jbody]


def test_port_resumes_jax_restart(runs, tmp_path):
    """JAX runs 2 iterations and writes its restart pair; the port resumes
    it and its iteration 3 matches JAX's uninterrupted iteration 3."""
    (jh, _), _, _ = runs
    _jax(tmp_path, maxItr=2)
    h, log = _port(
        tmp_path, maxItr=3,
        restartFileVec=str(tmp_path / "Restart00.npz"),
        restartFileVecSol=str(tmp_path / "RestartSol00.npz"),
    )
    assert any(line.startswith("# Continue optimization") for line in log)
    assert len(h["fx"]) == 1
    _assert_close(h, jh, [(0, 2)])


def test_jax_resumes_port_restart(runs, tmp_path):
    """The port's restart pair (written at the end of its 3-iteration run)
    loads in the JAX package, checksum included, and a JAX resume from it
    continues the port's trajectory."""
    _, (ph, _), pdir = runs
    path = os.path.join(pdir, "Restart00.npz")
    d = JaxRestart(str(tmp_path)).load(path)
    assert d is not None and int(d["itr"]) == 3
    with np.load(path) as z:
        assert set(z.files) == {"itr", "fscale", "x", "xPhys", "xo1", "xo2",
                                "U", "L", "checksum"}
        assert z["x"].dtype == np.float64 and z["xPhys"].dtype == np.float32
    ref, _ = _port(tmp_path / "p4", maxItr=4, restartFileVec=path,
                   restartFileVecSol=os.path.join(pdir, "RestartSol00.npz"))
    h, _ = _jax(tmp_path / "j4", maxItr=4, restartFileVec=path,
                restartFileVecSol=os.path.join(pdir, "RestartSol00.npz"))
    assert len(h["fx"]) == len(ref["fx"]) == 1
    _assert_close(ref, h, [(0, 0)])
