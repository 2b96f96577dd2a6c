"""The Chebyshev step kernel (csrc/chebyshev.cu) against the plain torch
smoother, on the card.  Marked `cuda`; skipped where no CUDA device is
visible.  Run on a GPU machine with
    python -m pytest --noconftest tests/test_torch_chebyshev_cuda.py

Bit for bit (`torch.equal`): the kernel forms the coefficients and every
vector operation as torch's f32 operations do, each rounded once, so the
smoother gives the plain form's bits.  Fields: resident (3, nx, ny, nz)
levels of the 257^3 hierarchy's shapes (33x17x17: an odd element count,
the kernel's scalar tail) and the PDE filter's dof-1 nodal field, with
dinv and lmax from the solvers' own set-up and their operators (K1, K3).
"""

import functools

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.models.elements import (
    helmholtz_element_matrices,
    hex8_stiffness,
)
from topopt_in_petsc_tpu_torch.ops.chebyshev import (
    CHEBYSHEV_STEP,
    chebyshev_step,
)
from topopt_in_petsc_tpu_torch.solvers.blocked_mg import BlockedElasticityMG
from topopt_in_petsc_tpu_torch.solvers.chebyshev import (
    chebyshev_smooth,
    chebyshev_smooth_plain,
)
from topopt_in_petsc_tpu_torch.solvers.multigrid import GeometricMultigrid

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# (dof, nn): resident elasticity levels, and the PDE filter's nodal field
FIELDS = [(3, (17, 17, 17)), (3, (33, 17, 17)), (3, (65, 65, 65)),
          (3, (129, 129, 129)), (1, (65, 33, 33))]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@functools.lru_cache(maxsize=None)
def _level(dof, nn):
    """(A, dinv, lmax, field shape) of one level: BlockedElasticityMG's
    (K1, dof 3) or the PDE filter's GeometricMultigrid (K3, dof 1) set up
    from a seeded element field."""
    dev = torch.device("cuda", 0)
    grid = Grid(nn=nn, lo=(0, 0, 0), hi=(2, 1, 1))
    rng = np.random.default_rng(sum(nn) + dof)
    E = torch.as_tensor(1e-9 + rng.uniform(0.0, 1.0, size=grid.ne) ** 3,
                        dtype=torch.float32, device=dev)
    if dof == 3:
        mg = BlockedElasticityMG([grid], [hex8_stiffness(*grid.h, 0.3)],
                                 device=dev)
        lvl = mg.setup(E)[0]
        return mg._A(0, lvl["eb"]), lvl["dinv"], lvl["lmax"], (3, *nn)
    KF = helmholtz_element_matrices(*grid.h, 0.08 / (2 * 3**0.5))[0]
    mg = GeometricMultigrid([grid], [KF], None, 1, device=dev)
    lvl = mg.setup(torch.ones_like(E))[0]
    return ((lambda v: mg.apply(0, lvl["coef"], v)), lvl["dinv"],
            lvl["lmax"], (*nn, 1))


def _field(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                           device=dev)


@pytest.mark.parametrize("x_is_zero", [True, False])
@pytest.mark.parametrize("degree", [1, 2, 4])
@pytest.mark.parametrize("dof,nn", FIELDS)
def test_kernel_steps_equal_plain_steps(dev, dof, nn, degree, x_is_zero):
    """`chebyshev_smooth` on f32 CUDA fields launches the kernel once per
    step and returns the plain form's bits; b and x stay as they were."""
    A, dinv, lmax, shape = _level(dof, nn)
    b, x = _field(shape, 1, dev), _field(shape, 2, dev)
    b0, x0 = b.clone(), x.clone()
    kw = dict(degree=degree, lower=0.06, upper=1.1, x_is_zero=x_is_zero)
    before = CHEBYSHEV_STEP.launches
    got = chebyshev_smooth(A, b, x, dinv, lmax, **kw)
    torch.cuda.synchronize()
    assert CHEBYSHEV_STEP.launches - before == degree
    ref = chebyshev_smooth_plain(A, b, x, dinv, lmax, **kw)
    torch.cuda.synchronize()
    assert CHEBYSHEV_STEP.launches - before == degree
    assert torch.equal(got, ref)
    assert torch.equal(b, b0) and torch.equal(x, x0)


@pytest.mark.parametrize("x_is_zero", [True, False])
def test_unaligned_fields_take_the_scalar_path(dev, x_is_zero):
    """Fields that start 4 bytes past a 16-byte boundary run the kernel's
    scalar path, with the same bits."""
    K1, dinv, lmax, shape = _level(3, (33, 17, 17))
    n = int(np.prod(shape))

    def A(v):  # K1 on an aligned copy
        return K1(v.clone())

    def shifted(t):
        buf = torch.empty(n + 1, dtype=torch.float32, device=dev)
        out = buf[1:].view(shape)
        out.copy_(t)
        return out

    b, x = shifted(_field(shape, 3, dev)), shifted(_field(shape, 4, dev))
    kw = dict(degree=4, lower=0.06, upper=1.1, x_is_zero=x_is_zero)
    got = chebyshev_smooth(A, b, x, shifted(dinv), lmax, **kw)
    ref = chebyshev_smooth_plain(A, b, x, dinv, lmax, **kw)
    torch.cuda.synchronize()
    assert b.data_ptr() % 16 == 4 and torch.equal(got, ref)


def test_step_refuses_bad_tensors(dev):
    """The wrapper raises on a field of another dtype or shape, a
    non-contiguous field and an lmax of more than one element; the entry
    point on an output it cannot store."""
    _, dinv, lmax, shape = _level(3, (17, 17, 17))
    b = _field(shape, 5, dev)
    d = torch.empty_like(b)
    with pytest.raises(ValueError, match="float32"):
        chebyshev_step(0, b.double(), None, None, dinv, None, lmax, 0.06,
                       1.1, d_out=d)
    with pytest.raises(ValueError, match="shape"):
        chebyshev_step(0, b, None, None, dinv[:, 1:], None, lmax, 0.06,
                       1.1, d_out=d)
    with pytest.raises(ValueError, match="contiguous"):
        chebyshev_step(0, b.transpose(1, 2), None, None,
                       dinv.transpose(1, 2), None, lmax, 0.06, 1.1,
                       d_out=d.transpose(1, 2))
    with pytest.raises(ValueError, match="one element"):
        chebyshev_step(0, b, None, None, dinv, None,
                       lmax.reshape(1).repeat(2), 0.06, 1.1, d_out=d)
    with pytest.raises(RuntimeError, match="chebyshev_step_f32"):
        chebyshev_step(0, b, None, None, dinv, None, lmax, 0.06, 1.1)
