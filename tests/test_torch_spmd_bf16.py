"""The reduced-precision V-cycle (`-mg_dtype bfloat16`) under
`-mesh_shape 2,2,2`, 17x9x9 nodes, 2 MG levels, f32, port against the JAX
package.

- Resident route (`-operator_impl blocked`): every rank's bf16 levels
  (K1's bf16-storage build on a card, its plain version here), their
  planes exchanged and added in bf16, the f32 outer operator; held to the
  JAX CLI's `-mesh_shape 2,2,2 -operator_impl blocked -mg_dtype bfloat16`
  history (`docs/jax_cpu_spmd_17x9x9_mesh222_blocked_bf16.npz`, its
  command in PERF.md; the JAX mesh runs this route, unlike the JAX
  single-device split solve, tests/test_torch_bf16_solvers.py) at the f32
  bars: fx rtol 1e-3, gx atol 1e-4, solver iterations within 1 (measured:
  1.8e-5 in fx, iterations 7, 7, 7, 8 against 7, 7, 8, 8).
- Nodal route: the JAX mesh's `SpmdMultigrid` takes no `-mg_dtype`, so
  its nodal V-cycle stays f32 (ROADMAP queue 3): its first iteration with
  `-mg_dtype bfloat16` gives the f32 run's fx bit for bit.  The port's
  nodal mesh follows its single-device rule: its bf16 run differs from
  its f32 run and agrees with the single-device bf16 run (fx rtol 1e-4,
  solver iterations within 1; measured 8 against 7: a shared plane's
  partial sums are rounded to bf16 on each block before they are added,
  where one device rounds the whole sum once).
"""

import contextlib
import io
import os

import numpy as np
import torch

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.driver import run_topopt as jax_run_topopt
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import run_topopt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = ["-nx", "17", "-ny", "9", "-nz", "9", "-nlvls", "2", "-rmin",
        "0.16", "-output_cadence_vtu", "0", "-restart", "0"]
MESH = ["-mesh_shape", "2,2,2"]
BF16 = ["-mg_dtype", "bfloat16"]


def _port(tmp, *flags):
    return run_topopt(TopOptConfig.from_args(
        ["-device", "cpu", *GRID, *flags, "-workdir", str(tmp)]))


def test_resident_bf16_mesh_matches_jax(tmp_path):
    h = _port(tmp_path, "-maxItr", "4", *MESH, "-operator_impl", "blocked",
              *BF16)
    with np.load(os.path.join(
            REPO, "docs", "jax_cpu_spmd_17x9x9_mesh222_blocked_bf16.npz")) \
            as r:
        ref = {k: r[k] for k in r.files}
    assert len(h["fx"]) == len(ref["fx"]) == 4
    np.testing.assert_allclose(h["fx"], ref["fx"], rtol=1e-3)
    np.testing.assert_allclose(h["gx"], ref["gx"], atol=1e-4)
    assert np.max(np.abs(np.subtract(h["iters"], ref["iters"]))) <= 1
    assert not np.any(h["stalled"])


def _jax_fx1(tmp, *flags):
    cfg = JaxConfig.from_args([*GRID, "-maxItr", "1", *MESH, *flags,
                               "-workdir", str(tmp)])
    with contextlib.redirect_stdout(io.StringIO()):
        return jax_run_topopt(cfg)["fx"][0]


def test_nodal_bf16_mesh_runs_bf16_where_jax_runs_f32(tmp_path):
    nodal = ["-maxItr", "1", "-operator_impl", "pallas"]
    f32 = _port(tmp_path / "f32", *nodal, *MESH)
    bf16 = _port(tmp_path / "bf16", *nodal, *MESH, *BF16)
    one = _port(tmp_path / "one", *nodal, *BF16)
    assert bf16["fx"][0] != f32["fx"][0]
    np.testing.assert_allclose(bf16["fx"], one["fx"], rtol=1e-4)
    assert abs(bf16["iters"][0] - one["iters"][0]) <= 1
    # the JAX mesh's nodal route on the CPU is `xla`
    jax = [_jax_fx1(tmp_path / f"jax{i}", "-operator_impl", "xla", *flags)
           for i, flags in enumerate(([], BF16))]
    assert jax[0] == jax[1]
