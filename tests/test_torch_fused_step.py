"""The port's fused step against the JAX package's, 17x9x9 nodes, 2 MG
levels, rmin 0.16, iterations 1-3 (so that each of the three variants
runs: fscale at iteration 1, fresh asymptotes at 1-2, the steady one at
3), on the CPU:

- default: the port's resident solve against JAX `make_fused_step` with
  `operator_impl "blocked"` (Pallas in interpret mode, as
  tests/test_fused_park.py runs it);
- nodal: the port's `-operator_impl pallas` against JAX `xla` (the same
  nodal math in plain XLA);
- filter2: the port's `-fused 1 -filter 2` against the JAX package's
  (its SPMD engine on one device), both through their CLI driver, with 2
  PDE-filter levels on both sides (the engine caps them at -nlvls).

Tolerances, as tests/test_torch_driver.py's for the split driver (f32
fields, sums in another order; the measured gap is ~1e-5 relative in
fx): fx rtol 2e-4; gx, ch and mnd absolute 1e-4; solver iterations
within 1.
"""

import contextlib
import io

import pytest
import torch

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.driver import run_topopt as jax_run
from topopt_in_petsc_tpu.parallel.fused_step import (
    make_fused_step as jax_make_fused_step,
)
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import run_topopt
from topopt_in_petsc_tpu_torch.parallel.fused_step import (
    OptState,
    make_fused_step,
)

torch.set_num_threads(1)

ARGS = dict(nx=17, ny=9, nz=9, nlvls=2, rmin=0.16)
FX_RTOL, ABS_TOL = 2e-4, 1e-4
KEYS = ("fx", "gx", "ch", "mnd", "iters")

# path -> (the port's options, the JAX package's options)
STEP_PATHS = {
    "default": ({}, {"operator_impl": "blocked"}),
    "nodal": ({"operator_impl": "pallas"}, {"operator_impl": "xla"}),
}


def _values(s):
    return {"fx": float(s.fx), "gx": float(s.gx[0]), "ch": float(s.ch),
            "mnd": float(s.mnd), "iters": int(s.solver_iters)}


def _trajectory(step, state):
    out = []
    for itr in (1, 2, 3):
        state = step(state, itr)
        out.append(_values(state))
    return out


def _as_rows(h):
    return [{k: h[k][i] for k in KEYS} for i in range(len(h["fx"]))]


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """path -> (JAX rows, port rows), each computed once."""
    cache = {}

    def get(path):
        if path in cache:
            return cache[path]
        if path == "filter2":
            kw = dict(ARGS, fused=True, filter=2, pde_nlvls=2, maxItr=3,
                      output_cadence_vtu=False)
            jcfg = JaxConfig(**kw, dtype="float32", workdir=str(
                tmp_path_factory.mktemp("jax_f2")))
            jcfg.validate()
            with contextlib.redirect_stdout(io.StringIO()):
                jh = jax_run(jcfg)
                th = run_topopt(TopOptConfig(**kw, device="cpu", workdir=str(
                    tmp_path_factory.mktemp("port_f2"))))
            cache[path] = (_as_rows(jh), _as_rows(th))
            return cache[path]
        port_kw, jax_kw = STEP_PATHS[path]
        jcfg = JaxConfig(**ARGS, dtype="float32", **jax_kw)
        jcfg.validate()
        jax_rows = _trajectory(*jax_make_fused_step(jcfg))
        step, state = make_fused_step(
            TopOptConfig(**ARGS, device="cpu", **port_kw))
        assert isinstance(state, OptState)
        cache[path] = (jax_rows, _trajectory(step, state))
        return cache[path]

    return get


@pytest.mark.parametrize("itr", [1, 2, 3])
@pytest.mark.parametrize("path", [*STEP_PATHS, "filter2"])
def test_fused_step_matches_jax(trajectories, path, itr):
    jax_rows, port_rows = trajectories(path)
    j, p = jax_rows[itr - 1], port_rows[itr - 1]
    assert p["fx"] == pytest.approx(j["fx"], rel=FX_RTOL)
    for k in ("gx", "ch", "mnd"):
        assert abs(p[k] - j[k]) <= ABS_TOL, (k, p[k], j[k])
    assert abs(p["iters"] - j["iters"]) <= 1


def test_step_updates_the_state_in_place():
    """The step writes into the state's tensors (the buffers a CUDA graph
    captures) and returns the same state."""
    step, state = make_fused_step(TopOptConfig(**ARGS, device="cpu"))
    ids = [id(t) for t in state]
    x0 = state.x.clone()
    out = step(state, 1)
    assert out is state
    assert [id(t) for t in out] == ids
    assert torch.equal(state.xo1, x0)
    assert not torch.equal(state.x, x0)
    assert int(state.solver_iters) > 0


def test_fused_pde_iterations_equal_the_eager_solves():
    """Under `-filter 2` the step keeps the iterations of each of its PDE
    solves (dfdx, dgdx, the design) in `pde_iters`, which the fused driver
    prints on a `#` line; each equals the eager solve's (opt/pde_filter.py
    `_solve`) of the same field from the same warm start, exactly."""
    step, state = make_fused_step(TopOptConfig(
        **ARGS, device="cpu", filter=2, pde_nlvls=2))
    pdef = step.pdef
    calls = []
    start = pdef.start

    def recording_start(x):
        calls.append((x.clone(), pdef._u.clone()))
        return start(x)

    pdef.start = recording_start
    xt, xp = step.project(state.x, state.beta)
    state.xTilde.copy_(xt)
    state.xPhys.copy_(xp)
    for itr in (1, 2, 3):
        calls.clear()
        step(state, itr)
        eager = [int(pdef._solve(x, u0)[2]) for x, u0 in calls]
        assert len(eager) == 3 and min(eager) > 0
        assert step.pde_iters.tolist() == eager
