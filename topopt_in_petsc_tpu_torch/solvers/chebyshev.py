"""Chebyshev polynomial smoother with Jacobi (diagonal) scaling.

The reference smooths each multigrid level with GMRES(4)+SOR
(LinearElasticity.cc:734-746) and its own comments recommend Chebyshev for
SPD problems (cc:739-745).  Chebyshev-Jacobi is matrix-free (only K@v and
diag(K)), parallel, and a fixed linear operator, which keeps the V-cycle
an SPD preconditioner.

Smoothing band: [lower * lmax, upper * lmax] with lmax from the certain
Gershgorin bound (`gershgorin_lambda_max`): an underestimated band makes
the smoother amplify the top modes and diverges f32 solves at high SIMP
contrast.

`chebyshev_smooth` takes one of two forms of the same arithmetic, by the
fields it is given: on f32 CUDA fields each step is one kernel,
ops/chebyshev.py::chebyshev_step (`chebyshev_smooth_steps`); bf16, f64
and CPU fields take the plain torch steps (`chebyshev_smooth_plain`).
Both give the same bits.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from topopt_in_petsc_tpu_torch.ops.chebyshev import (
    chebyshev_band,
    chebyshev_step,
)


def gershgorin_lambda_max(
    abs_rowsum: torch.Tensor,
    diag: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Certain upper bound on lambda_max(D^-1 A): max_i R_i / D_i with R the
    absolute row sums.  Masked (Dirichlet) rows are identity: ratio 1."""
    ratio = abs_rowsum / diag
    if mask is not None:
        ratio = torch.where(mask > 0, ratio, torch.ones_like(ratio))
    return torch.max(ratio)


def chebyshev_smooth(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x: torch.Tensor,
    dinv: torch.Tensor,
    lmax: torch.Tensor,
    *,
    degree: int = 4,
    lower: float = 0.1,
    upper: float = 1.1,
    x_is_zero: bool = False,
) -> torch.Tensor:
    """`degree` Chebyshev iterations targeting D^-1 A in [lower, upper]*lmax
    (three-term recurrence maintaining the true residual).

    `x_is_zero=True` declares the initial guess zero (V-cycle presmoothing):
    the initial residual is `b`, which saves one operator application.
    One kernel per step on f32 CUDA fields, else the plain torch steps
    (the module's docstring).
    """
    kw = dict(degree=degree, lower=lower, upper=upper, x_is_zero=x_is_zero)
    if b.is_cuda and b.dtype == torch.float32:
        return chebyshev_smooth_steps(A, b, x, dinv, lmax, **kw)
    return chebyshev_smooth_plain(A, b, x, dinv, lmax, **kw)


def chebyshev_smooth_plain(A, b, x, dinv, lmax, *, degree: int = 4,
                           lower: float = 0.1, upper: float = 1.1,
                           x_is_zero: bool = False) -> torch.Tensor:
    """`chebyshev_smooth` in plain torch operations."""
    theta, delta, sigma = chebyshev_band(lmax, lower, upper, b.dtype)
    rho = 1.0 / sigma

    # each name rebound as soon as its new value exists, so that no old
    # field outlives its last use (the bf16 V-cycle's peak memory)
    r = b if x_is_zero else b - A(x)
    d = (dinv * r) / theta
    x = d if x_is_zero else x + d
    for _ in range(degree - 1):
        r = r - A(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv * r)
        x = x + d
        rho = rho_new
    return x


def chebyshev_smooth_steps(A, b, x, dinv, lmax, *, degree: int = 4,
                           lower: float = 0.1, upper: float = 1.1,
                           x_is_zero: bool = False) -> torch.Tensor:
    """`chebyshev_smooth` on f32 CUDA fields as `degree` launches of
    `chebyshev_step`, each after the same operator application as
    `chebyshev_smooth_plain`'s step, with its bits.  The caller's b and x
    are read, never written; the steps update their own r, d and x in
    place, and the last one stores x alone."""
    band = dict(lmax=lmax, lower=lower, upper=upper)
    b, dinv = b.contiguous(), dinv.contiguous()

    def new():
        return torch.empty_like(b)

    if x_is_zero:
        d = new()
        chebyshev_step(0, b, None, None, dinv, None, d_out=d, **band)
        r, x = b, d  # x is d until the next step stores an x of its own
    else:
        x = x.contiguous()
        r, d = (new(), new()) if degree > 1 else (None, None)
        x_new = new()
        chebyshev_step(0, b, A(x).contiguous(), None, dinv, x, r_out=r,
                       d_out=d, x_out=x_new, **band)
        x = x_new
    for k in range(1, degree):
        last = k == degree - 1
        ad = A(d).contiguous()
        # after a start from zero r is the caller's b and x is d
        fresh = x is d
        r_out = None if last else new() if fresh else r
        x_out = new() if fresh else x
        chebyshev_step(k, r, ad, d, dinv, x, r_out=r_out,
                       d_out=None if last else d, x_out=x_out, **band)
        r, x = r_out, x_out
    return x
