"""The Chebyshev smoother (solvers/chebyshev.py) on the CPU:
`chebyshev_smooth` takes the plain torch steps for CPU fields of every
dtype and launches no kernel, and the step kernel's wrapper
(ops/chebyshev.py::chebyshev_step) refuses CPU tensors.  The kernel's
steps against the plain ones are held on the card
(tests/test_torch_chebyshev_cuda.py).

Bit for bit (`torch.equal`): both forms run the same f32 or f64
operations in the same order.
"""

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.models.elements import hex8_stiffness
from topopt_in_petsc_tpu_torch.ops.chebyshev import (
    CHEBYSHEV_STEP,
    chebyshev_step,
)
from topopt_in_petsc_tpu_torch.solvers.blocked_mg import BlockedElasticityMG
from topopt_in_petsc_tpu_torch.solvers.chebyshev import (
    chebyshev_smooth,
    chebyshev_smooth_plain,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
NN = (9, 5, 5)


def _case(dtype, x_is_zero):
    """(A, b, x, dinv, lmax) in `dtype` from a resident 9x5x5 level: K1's
    plain version, dinv and lmax of `BlockedElasticityMG.setup`, b and x
    from a seed; A counts its calls in `A.calls`."""
    grid = Grid(nn=NN, lo=(0, 0, 0), hi=(2, 1, 1))
    mg = BlockedElasticityMG([grid], [hex8_stiffness(*grid.h, 0.3)],
                             device=CPU)
    rng = np.random.default_rng(7)
    E = torch.as_tensor(1e-9 + rng.uniform(0.0, 1.0, size=grid.ne) ** 3,
                        dtype=torch.float32)
    lvl = mg.setup(E)[0]
    A32 = mg._A(0, lvl["eb"])

    def A(v):
        A.calls += 1
        return A32(v.float()).to(dtype)

    A.calls = 0
    b = mg._mask0(torch.as_tensor(rng.normal(size=(3, *NN)), dtype=dtype))
    x = b if x_is_zero else mg._mask0(
        torch.as_tensor(rng.normal(size=(3, *NN)), dtype=dtype))
    lmax = lvl["lmax"].to(torch.float64 if dtype == torch.float64
                          else torch.float32)
    return A, b, x, lvl["dinv"].to(dtype), lmax


@pytest.mark.parametrize("degree", [1, 2, 4])
@pytest.mark.parametrize("x_is_zero", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_cpu_fields_take_the_plain_steps(dtype, x_is_zero, degree):
    """On CPU fields `chebyshev_smooth` returns the plain form's result
    exactly and launches no kernel."""
    A, b, x, dinv, lmax = _case(dtype, x_is_zero)
    kw = dict(degree=degree, lower=0.06, upper=1.1, x_is_zero=x_is_zero)
    before = CHEBYSHEV_STEP.launches
    got = chebyshev_smooth(A, b, x, dinv, lmax, **kw)
    ref = chebyshev_smooth_plain(A, b, x, dinv, lmax, **kw)
    assert CHEBYSHEV_STEP.launches == before
    assert got.dtype == dtype and torch.equal(got, ref)


@pytest.mark.parametrize("form", ["from_zero", "from_x", "step"])
def test_step_refuses_cpu_tensors(form):
    """The kernel's wrapper raises on CPU fields, in each form of the step,
    and launches nothing: the kernel has no CPU mode, and CPU fields take
    the plain steps before they reach it."""
    A, b, x, dinv, lmax = _case(torch.float32, False)
    ad, r, d, xs = A(x), b.clone(), x.clone(), x.clone()
    args = {"from_zero": (0, b, None, None, dinv, None),
            "from_x": (0, b, ad, None, dinv, x),
            "step": (2, r, ad, d, dinv, xs)}[form]
    outs = {"from_zero": dict(d_out=d),
            "from_x": dict(r_out=r, d_out=d, x_out=xs),
            "step": dict(r_out=r, d_out=d, x_out=xs)}[form]
    before = CHEBYSHEV_STEP.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        chebyshev_step(*args, lmax, 0.06, 1.1, **outs)
    assert CHEBYSHEV_STEP.launches == before
