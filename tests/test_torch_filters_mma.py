"""Port vs JAX package: density/sensitivity filters (direct and FFT
convolution, with and without projection), the filter chain rule, beta
continuation, MND, and one f64 MMA update.

Tolerances: filter outputs 1e-5 relative to max (f32 convolutions summed
in another order; the FFT path rounds differently from the direct one);
the MMA update in f64, 1e-7 of max|x|: the dual interior point stops at a
residual of 1e-9 sqrt(m+n), so two correct solvers whose sums round
differently agree to that order, not to f64 precision.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.grid import Grid as JaxGrid
from topopt_in_petsc_tpu.opt.filters import DesignFilter as JaxFilter
from topopt_in_petsc_tpu.opt.mma import MMA as JaxMMA
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.ops.conv_filter import (
    conv3d_direct,
    make_fft_conv,
    next_smooth,
)
from topopt_in_petsc_tpu_torch.opt.filters import DesignFilter
from topopt_in_petsc_tpu_torch.opt.mma import MMA

torch.set_num_threads(1)

CPU = torch.device("cpu")
NN = (17, 9, 9)


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def test_next_smooth():
    assert [next_smooth(n) for n in (1, 7, 37, 296, 444)] == \
        [1, 8, 40, 300, 450]


def test_fft_conv_matches_direct():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(size=(12, 10, 7)).astype(np.float32))
    k = rng.uniform(size=(5, 5, 5))
    k = (k + k[::-1, ::-1, ::-1]) / 2  # the filter kernels are symmetric
    direct = conv3d_direct(x, torch.tensor(k, dtype=torch.float32))
    fft = make_fft_conv(x.shape, k, torch.float32, CPU)(x)
    _close(fft.numpy(), direct.numpy())


# h = 0.125: rmin 0.16 -> 3^3 taps (direct conv), 0.6 -> 9^3 taps (FFT)
@pytest.mark.parametrize("filt", [0, 1])
@pytest.mark.parametrize("rmin", [0.16, 0.6])
@pytest.mark.parametrize("projection", [False, True])
def test_filter_matches_jax(filt, rmin, projection):
    argv = ["-nx", str(NN[0]), "-ny", str(NN[1]), "-nz", str(NN[2]),
            "-nlvls", "2", "-rmin", str(rmin), "-filter", str(filt),
            "-projectionFilter", str(int(projection)), "-beta", "4",
            "-eta", "0.4"]
    jcfg, tcfg = JaxConfig.from_args(argv), TopOptConfig.from_args(argv)
    jf = JaxFilter(jcfg, JaxGrid.from_config(jcfg))
    tf = DesignFilter(tcfg, Grid.from_config(tcfg), device=CPU)
    assert (jf._fft_conv is None) == (tf._fft_conv is None) == (rmin < 0.5)
    rng = np.random.default_rng(1)
    ne = tuple(n - 1 for n in NN)
    x = rng.uniform(0.001, 1.0, size=ne).astype(np.float32)
    dfdx = -rng.uniform(size=ne).astype(np.float32)
    dgdx = np.full((1, *ne), 1.0 / np.prod(ne), np.float32)

    jt, jp = jf.filter_project(jnp.asarray(x))
    tt, tp = tf.filter_project(torch.from_numpy(x))
    _close(tt.numpy(), jt)
    _close(tp.numpy(), jp)
    jdf, jdg = jf.gradients(jnp.asarray(x), jt, jnp.asarray(dfdx),
                            jnp.asarray(dgdx))
    tdf, tdg = tf.gradients(torch.from_numpy(x), tt, torch.from_numpy(dfdx),
                            torch.from_numpy(dgdx))
    _close(tdf.numpy(), jdf)
    _close(tdg.numpy(), jdg)
    assert tf.get_mnd(tp) == pytest.approx(jf.get_mnd(jp), rel=1e-5)


@pytest.mark.parametrize("args", [
    (1.0, 48.0, 0.0, 10, 0.5), (7.5, 48.0, 0.0, 3, 0.005),
    (47.0, 48.0, 0.0, 20, 0.2), (2.0, 48.0, 1e-3, 10, 0.2),
])
def test_increase_beta_matches(args):
    assert DesignFilter.increase_beta(*args) == \
        JaxFilter.increase_beta(*args)


def test_no_filter_passes_design_through():
    cfg = TopOptConfig.from_args(["-nx", "9", "-ny", "5", "-nz", "5",
                                  "-nlvls", "2", "-filter", "3"])
    f = DesignFilter(cfg, Grid.from_config(cfg), device=CPU)
    x = torch.rand((8, 4, 4))
    assert torch.equal(f.filter_project(x)[0], x)


def test_mma_updates_match_jax_f64():
    """Three updates from the same inputs: fresh asymptotes, then the
    oscillation heuristic, with the first design in f32 as the driver
    passes it."""
    shape = (8, 4, 4)
    n = int(np.prod(shape))
    rng = np.random.default_rng(3)
    jm = JaxMMA(n, 1, shape, dtype=jnp.float64)
    tm = MMA(n, 1, shape, device=CPU)
    xj = jnp.full(shape, 0.12, jnp.float32)
    xt = torch.full(shape, 0.12, dtype=torch.float32)
    for _ in range(3):
        dfdx = -rng.uniform(0.1, 1.0, size=shape)
        gx = np.array([float(np.mean(np.asarray(xt))) - 0.12])
        dgdx = np.full((1, *shape), 1.0 / n)
        jlo, jhi = jm.set_outer_movelimit(0.0, 1.0, 0.2, xj)
        tlo, thi = tm.set_outer_movelimit(0.0, 1.0, 0.2, xt)
        _close(tlo.numpy(), jlo, 1e-15)
        _close(thi.numpy(), jhi, 1e-15)
        xj_new = jm.update(xj, jnp.asarray(dfdx), jnp.asarray(gx),
                           jnp.asarray(dgdx), jlo, jhi)
        xt_new = tm.update(xt, torch.from_numpy(dfdx), torch.from_numpy(gx),
                           torch.from_numpy(dgdx), tlo, thi)
        assert xt_new.dtype == torch.float64
        _close(xt_new.numpy(), xj_new, 1e-7)
        chj, _ = jm.design_change(xj_new, xj)
        cht, _ = tm.design_change(xt_new, xt)
        assert cht == pytest.approx(chj, rel=1e-7)
        xj, xt = xj_new, xt_new
    for a, b in zip(tm.restart_vectors(), jm.restart_vectors()):
        _close(a.numpy(), b, 1e-7)
