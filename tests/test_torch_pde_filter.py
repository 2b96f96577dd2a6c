"""Port vs JAX package: the Helmholtz PDE filter (`-filter 2`,
opt/pde_filter.py) on 17x9x9 nodes with pde_nlvls 2 and rmin 0.16, and
the properties the JAX package's tests/test_filters.py holds its own
filter to, on the port.

Each filter solve warm-starts from the previous one's solution, and the
two packages' constructors draw their smoke-test designs from different
generators, so the comparison first sets both filters' warm starts to
the same seeded field and then runs the same sequence of calls on both.
Tolerance: xTilde and the filtered gradients to abs 1e-5 (f32 solves to
pde_rtol 1e-8, sums in another order).
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.grid import Grid as JaxGrid
from topopt_in_petsc_tpu.opt.filters import DesignFilter as JaxFilter
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.opt.filters import DesignFilter

torch.set_num_threads(1)

CPU = torch.device("cpu")
ARGS = dict(nx=17, ny=9, nz=9, nlvls=2, rmin=0.16, filter=2, pde_nlvls=2)
ATOL = 1e-5


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


@pytest.fixture(scope="module")
def pair():
    """(port filter, JAX filter), warm starts set to one seeded field."""
    cfg = TopOptConfig(**ARGS, device="cpu")
    cfg.validate()
    jcfg = JaxConfig(**ARGS)
    jcfg.validate()
    port = _quiet(DesignFilter, cfg, Grid.from_config(cfg), device=CPU)
    ref = _quiet(JaxFilter, jcfg, JaxGrid.from_config(jcfg))
    u0 = np.random.default_rng(0).uniform(
        size=(*cfg_nn(cfg), 1)).astype(np.float32)
    port.pdef.set_warm_start(u0)
    ref.pdef._u = jnp.asarray(u0)
    return port, ref


def cfg_nn(cfg):
    return (cfg.nx, cfg.ny, cfg.nz)


def _design(seed, shape=(16, 8, 8)):
    return np.random.default_rng(seed).uniform(
        0.05, 0.95, size=shape).astype(np.float32)


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_filter_project_matches_jax(pair):
    port, ref = pair
    for seed, projection in ((1, False), (2, True), (3, False)):
        x = _design(seed)
        xt, xp = _quiet(port.filter_project, torch.from_numpy(x),
                        projection, 2.0, 0.5)
        jt, jp = _quiet(ref.filter_project, jnp.asarray(x), projection,
                        2.0, 0.5)
        _close(xt, jt)
        _close(xp, jp)
        # the warm start each solve leaves behind matches too
        _close(port.pdef._u, ref.pdef._u)


@pytest.mark.parametrize("projection", [False, True])
def test_gradients_match_jax(pair, projection):
    port, ref = pair
    x, xTilde = _design(4), _design(5)
    dfdx = -np.random.default_rng(6).uniform(
        size=x.shape).astype(np.float32)
    dgdx = np.full((2, *x.shape), 1.0 / x.size, np.float32)
    gf, gg = port.gradients(*map(torch.from_numpy, (x, xTilde, dfdx, dgdx)),
                            projection, 2.0, 0.5)
    jf, jg = ref.gradients(*map(jnp.asarray, (x, xTilde, dfdx, dgdx)),
                           projection, 2.0, 0.5)
    assert gg.shape == (2, *x.shape)
    _close(gf, jf)
    _close(gg, jg)


def test_bound_violation_is_reported_and_clipped(pair):
    port, _ = pair
    x = np.zeros((16, 8, 8), np.float32)
    x[6:10, 2:6, 2:6] = 4.0  # a filtered value far above 1
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        xt, _ = port.filter_project(torch.from_numpy(x), False, 1.0, 0.5)
    assert "BOUND VIOLATION IN PDEFILTER" in buf.getvalue()
    assert float(xt.max()) <= 1.0 and float(xt.min()) >= 0.0


# -- properties, as tests/test_filters.py holds the JAX filter ---------- #
# (there in f64; the port is f32, so the bars are f32's: constants to
# 1e-6 and the adjoint identity to 1e-5 relative)


@pytest.fixture(scope="module")
def cube():
    cfg = TopOptConfig(nx=9, ny=9, nz=9, nlvls=1, rmin=0.3, filter=2,
                       pde_nlvls=2, xcmax=1.0, ycmax=1.0, zcmax=1.0,
                       device="cpu")
    cfg.validate()
    grid = Grid.from_config(cfg)
    return grid, _quiet(DesignFilter, cfg, grid, device=CPU)


def test_preserves_constants(cube):
    grid, filt = cube
    xTilde, _ = filt.filter_project(torch.full(grid.ne, 0.42))
    np.testing.assert_allclose(xTilde.numpy(), 0.42, atol=1e-6)


def test_self_adjoint(cube):
    grid, filt = cube
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.uniform(size=grid.ne).astype(np.float32))
    b = torch.from_numpy(rng.uniform(size=grid.ne).astype(np.float32))
    Fa = filt.pdef.filter_project(a)
    Fb = filt.pdef.filter_project(b)
    lhs = float(torch.sum(Fa.double() * b.double()))
    rhs = float(torch.sum(a.double() * Fb.double()))
    assert abs(lhs - rhs) < 1e-5 * abs(lhs)


def test_smoothing(cube):
    grid, filt = cube
    x = np.random.default_rng(6).uniform(size=grid.ne)
    xTilde, _ = filt.filter_project(torch.from_numpy(x))
    xt = xTilde.numpy()
    assert xt.var() < 0.25 * x.var()
    assert abs(xt.mean() - x.mean()) < 5e-3
