"""The reduced-precision V-cycle end to end: the port's drivers with
`-mg_dtype bfloat16`, `mixed` and `-mg_fine_post 1`, split and `-fused 1`,
on the resident and the nodal path, at 33x17x17 nodes on 3 levels for 3
iterations, against the JAX package's split driver on its nodal path
(`operator_impl "xla"`, the CLI's default on the CPU).

- fx within 1e-3 (relative) of the JAX package's f32 run: the outer
  Krylov is f32 and converges to the same -ksp_rtol, so the design
  trajectory is the f32 one; the bf16 V-cycle only steers it.
- solver iterations of the port's nodal bf16 run: no more than 2 above
  the JAX package's nodal bf16 run, and no fewer than its f32 run's less
  1.  The two bf16 V-cycles do not round alike: the JAX package's nodal
  levels on the CPU run its plain operator in bf16 (coefficient and
  element matrix cast), the port's run K4 in f32 on the widened input, as
  the JAX package's Pallas path does, and need up to 3 fewer iterations.
  (The JAX package's resident bf16 path cannot run here: see
  tests/test_torch_bf16_solvers.py.)
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.driver import Driver as JaxDriver
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import run_topopt

torch.set_num_threads(1)

ARGS = dict(nx=33, ny=17, nz=17, nlvls=3, maxItr=3,
            output_cadence_vtu=False, restart=False)
FX_RTOL = 1e-3


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def _jax(workdir, **kw):
    cfg = JaxConfig(**ARGS, operator_impl="xla", workdir=str(workdir), **kw)
    cfg.validate()
    return _quiet(lambda: JaxDriver(cfg).run())


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's f32 and nodal bf16 histories."""
    return {m: _jax(tmp_path_factory.mktemp(f"jax_{m}"), mg_dtype=m)
            for m in ("same", "bfloat16")}


# the port's runs: name -> options
RUNS = {
    "bf16 split": dict(mg_dtype="bfloat16"),
    "bf16 fused": dict(mg_dtype="bfloat16", fused=True),
    "bf16 nodal split": dict(mg_dtype="bfloat16", operator_impl="pallas"),
    "bf16 nodal fused": dict(mg_dtype="bfloat16", operator_impl="pallas",
                             fused=True),
    "mixed split": dict(mg_dtype="mixed"),
    "mixed fused": dict(mg_dtype="mixed", fused=True),
    "bf16 fine_post split": dict(mg_dtype="bfloat16", mg_fine_post=1),
}


@pytest.mark.parametrize("run", RUNS)
def test_bf16_vcycle_run_matches_jax_f32(jax_runs, tmp_path, run):
    cfg = TopOptConfig(**ARGS, device="cpu", workdir=str(tmp_path),
                       **RUNS[run])
    h = _quiet(run_topopt, cfg)
    ref = jax_runs["same"]
    assert len(h["fx"]) == 3 and not any(h["stalled"])
    np.testing.assert_allclose(h["fx"], ref["fx"], rtol=FX_RTOL)
    np.testing.assert_allclose(h["gx"], ref["gx"], rtol=0, atol=1e-4)
    if cfg.operator_impl == "pallas":
        its = np.asarray(h["iters"])
        assert np.all(its <= np.asarray(jax_runs["bfloat16"]["iters"]) + 2)
        assert np.all(its >= np.asarray(ref["iters"]) - 1)
