"""One step of the Chebyshev-Jacobi smoother in one kernel.

`chebyshev_step` runs csrc/chebyshev.cu on f32 CUDA tensors.  It forms
the step's coefficients from the 0-d bound lmax as `chebyshev_band` does
and gives the bits of solvers/chebyshev.py::chebyshev_smooth_plain's step,
which chebyshev_smooth_steps drives one step at a time.

A step follows one operator application (ad, A x at a start from x, A d
after it); an output may be its own input (the smoother's own r, d and x
are updated where they lie):

- step 0 without ad (the start from zero): d_out = (dinv b) / theta;
- step 0 with ad = A x: r_out = b - A x, d_out = (dinv r) / theta,
  x_out = x + d;
- step k >= 1 with ad = A d: r_out = r - A d, d_out = (rho' rho) d +
  (2 rho' / delta) (dinv r), x_out = x + d, with x the old d where x is d
  itself (the step after a start from zero).

r_out and d_out may both be None (the last step stores x alone).
"""

from __future__ import annotations

from typing import Optional

import torch

from topopt_in_petsc_tpu_torch.ops.cuda_build import (
    CudaKernel,
    check_cuda_tensor,
)

# the smoother's margin on the Gershgorin bound: the band's top is
# upper * LMAX_MARGIN * lmax
LMAX_MARGIN = 1.01

CHEBYSHEV_STEP = CudaKernel("chebyshev_step_f32")


def chebyshev_band(lmax, lower: float, upper: float, dtype):
    """(theta, delta, sigma) of the band [lower, upper] * LMAX_MARGIN *
    lmax, as 0-d tensors in `dtype`: the band's centre, its half width
    and their ratio."""
    lmax = (torch.as_tensor(lmax) * LMAX_MARGIN).to(dtype)
    lmin = lower * lmax
    lmax_b = upper * lmax
    theta = 0.5 * (lmax_b + lmin)
    delta = 0.5 * (lmax_b - lmin)
    return theta, delta, theta / delta


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def chebyshev_step(step: int, r: torch.Tensor, ad: Optional[torch.Tensor],
                   d: Optional[torch.Tensor], dinv: torch.Tensor,
                   x: Optional[torch.Tensor], lmax: torch.Tensor,
                   lower: float, upper: float, *,
                   r_out: Optional[torch.Tensor] = None,
                   d_out: Optional[torch.Tensor] = None,
                   x_out: Optional[torch.Tensor] = None) -> None:
    """One smoothing step, into the given outputs (the module's docstring).
    r is b at a start.  Contiguous f32 CUDA fields of one shape, and lmax
    an f32 CUDA tensor of one element; raises on other dtypes, shapes,
    layouts and on CPU tensors."""
    fields = dict(r=r, ad=ad, d=d, dinv=dinv, x=x, r_out=r_out, d_out=d_out,
                  x_out=x_out)
    for name, t in fields.items():
        if t is not None:
            check_cuda_tensor(t, name, r.shape, torch.float32)
    check_cuda_tensor(lmax, "lmax", lmax.shape, torch.float32)
    if lmax.numel() != 1:
        raise ValueError(f"lmax: expected one element, got {lmax.numel()}")
    CHEBYSHEV_STEP(*(_ptr(t) for t in fields.values()), lmax.data_ptr(),
                   LMAX_MARGIN, float(lower), float(upper), step, r.numel())
