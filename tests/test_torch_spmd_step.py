"""The state solve and one optimization step of `-mesh_shape` against the
JAX SPMD engine, at 2 ranks (mesh (2,1,1)), 17x9x9 nodes, 2 MG levels.

The port's step runs on ranks of its own launcher (`-device cpu`,
`parallel/spmd_driver.py::run_rank` for one iteration); the JAX side is
`make_spmd_fused_step` on two virtual CPU devices, after the driver's
pre-loop filter, as its `SpmdDriver` runs it.

Bars: float64 on the `xla` route, fx rtol 1e-8 and the same solver
iterations; float32 on the `blocked` (K1) and `pallas` (K4) routes, fx
rtol 1e-4 and solver iterations within 1, against the JAX engine's `xla`
route in float32: its `pallas` route does not run on the CPU (Pallas
needs interpret mode there, which the engine does not ask for) and its
`blocked` route in interpret mode takes about 18 s per compiled variant;
the 4-iteration CLI history of that route is held in
tests/test_torch_spmd_cli.py.

Also: MMA with no reduction hooks is the single-device MMA, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.parallel.mesh import make_device_mesh
from topopt_in_petsc_tpu.parallel.spmd_model import make_spmd_fused_step
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.opt.mma import MMA
from topopt_in_petsc_tpu_torch.parallel.multihost import spawn
from topopt_in_petsc_tpu_torch.parallel.spmd_driver import run_rank

torch.set_num_threads(1)

ARGS = dict(nx=17, ny=9, nz=9, nlvls=2, rmin=0.16)
MESH = (2, 1, 1)
_JAX = {}


def _jax_step(dtype):
    """(fx, solver iterations, ch, mnd, gx[0]) of the JAX engine's first
    iteration on the `xla` route."""
    if dtype not in _JAX:
        cfg = JaxConfig(**ARGS, dtype=dtype, operator_impl="xla",
                        mesh_shape=MESH)
        cfg.validate()
        mesh = make_device_mesh(MESH, jax.devices()[:2])
        step, s, eng = make_spmd_fused_step(cfg, mesh=mesh)
        xTilde, xPhys, u_pde = eng.filter_project_blk(s.x, s.beta, s.u_pde)
        out = step(s._replace(xTilde=xTilde, xPhys=xPhys, u_pde=u_pde), 1)
        _JAX[dtype] = (float(out.fx), int(out.solver_iters), float(out.ch),
                       float(out.mnd), float(out.gx[0]))
    return _JAX[dtype]


@pytest.mark.parametrize("route,dtype,rtol,iters", [
    ("xla", "float64", 1e-8, 0),
    ("blocked", "float32", 1e-4, 1),
    ("pallas", "float32", 1e-4, 1),
])
def test_solve_and_step_match_jax_engine(route, dtype, rtol, iters,
                                         tmp_path):
    cfg = TopOptConfig(**ARGS, dtype=dtype, operator_impl=route,
                       mesh_shape=MESH, device="cpu", restart=False,
                       output_cadence_vtu=False, workdir=str(tmp_path))
    h = spawn(MESH, run_rank, [(cfg, 1)] * 2)[0]
    fx, its, ch, mnd, gx0 = _jax_step(dtype)
    assert h["fx"][0] == pytest.approx(fx, rel=rtol)
    assert abs(h["iters"][0] - its) <= iters
    tol = 1e-10 if dtype == "float64" else 1e-5
    assert abs(h["ch"][0] - ch) <= tol
    assert abs(h["mnd"][0] - mnd) <= tol
    assert abs(h["gx"][0] - gx0) <= tol


def test_mma_without_hooks_is_the_single_device_mma():
    """The reduction hooks default to the local reductions: an update
    with them passed explicitly is the update without them, bit for
    bit."""
    rng = np.random.default_rng(5)
    shape, m = (6, 4, 4), 2
    n = int(np.prod(shape))
    f64 = torch.float64
    x = torch.as_tensor(rng.uniform(0.2, 0.8, shape))
    dfdx = torch.as_tensor(-rng.uniform(0.1, 1.0, shape))
    dgdx = torch.as_tensor(rng.uniform(0.5, 1.5, (m, *shape)) / n)
    gx = torch.tensor([0.01, -0.02], dtype=f64)
    xmin, xmax = MMA._movelimit_impl(x, 0.0, 1.0, 0.2)
    out = []
    for hooks in ({}, dict(
            reduce_sum=lambda v: torch.sum(v, dtype=f64),
            reduce_max=torch.max, reduce_matrix=lambda H: H)):
        mma = MMA(n, m, shape, device="cpu", **hooks)
        xs = [mma.update(x, dfdx, gx, dgdx, xmin, xmax) for _ in range(3)]
        out.append((torch.stack(xs), mma.design_change(xs[-1], x)[0]))
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
