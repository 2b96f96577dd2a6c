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
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


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
    """
    lmax = (torch.as_tensor(lmax) * 1.01).to(b.dtype)
    lmin = lower * lmax
    lmax_b = upper * lmax
    theta = 0.5 * (lmax_b + lmin)
    delta = 0.5 * (lmax_b - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma

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
