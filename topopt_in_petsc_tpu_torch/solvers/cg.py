"""Preconditioned (flexible) conjugate gradients.

The reference's outer Krylov is FGMRES(100) (LinearElasticity.cc:638-650);
K is SPD after the symmetric Dirichlet treatment (cc:530-538), so with an
SPD multigrid preconditioner CG applies.  The flexible (Polak-Ribiere)
variant is the default; it tolerates the slight nonstationarity of a CG
coarse-level solve, the robustness role FGMRES plays in the reference.

The loop runs eagerly on the host: scalars stay 0-d device tensors, and
the one host sync per iteration is the convergence test.  Dot products
sum f32 products in f64 when `precise_dots`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


def _dot(a: torch.Tensor, b: torch.Tensor, precise: bool) -> torch.Tensor:
    """Inner product; f32 products summed in f64 when `precise`."""
    if precise and a.dtype != torch.float64:
        return torch.sum(a * b, dtype=torch.float64)
    return torch.sum(a * b)


def accurate_sum(v: torch.Tensor, precise: bool = True) -> torch.Tensor:
    """Sum of all entries, accumulated in f64 when `precise`."""
    if precise and v.dtype != torch.float64:
        return torch.sum(v, dtype=torch.float64)
    return torch.sum(v)


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    relres: torch.Tensor  # final ||r|| / ||b||, 0-d


def pcg(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 200,
    flexible: bool = True,
    precise_dots: bool = True,
    dot: Optional[Callable] = None,
) -> CGResult:
    """Solve A x = b with preconditioned CG from a nonzero initial guess;
    converged when the true residual 2-norm falls to rtol * ||b||
    (reference solver contract, LinearElasticity.cc:619-647).

    Flexible (Polak-Ribiere) beta is z.(r_new - r_old) = -alpha * z.Ap.
    alpha and beta are rounded to the field dtype before use, as in the
    JAX package, so iteration counts track it.
    """
    if M is None:
        M = lambda r: r  # noqa: E731
    if dot is None:
        dot = lambda a, c: _dot(a, c, precise_dots)  # noqa: E731

    vdt = x0.dtype
    x = x0
    r = b - A(x0)
    z = M(r)
    rz = dot(r, z)
    bnorm = torch.sqrt(dot(b, b))
    rnorm = torch.sqrt(dot(r, r))
    p = z
    tol = torch.clamp(rtol * bnorm, min=atol)
    k = 0
    while k < maxiter and bool(rnorm > tol):
        Ap = A(p)
        pAp = dot(p, Ap)
        alpha = (rz / pAp).to(vdt)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        if flexible:
            beta_num = -alpha * dot(z, Ap)
        else:
            beta_num = dot(z, r)
        rz_old, rz = rz, dot(r, z)
        beta = (beta_num / rz_old).to(vdt)
        p = z + beta * p
        rnorm = torch.sqrt(dot(r, r))
        k += 1
    return CGResult(
        x=x, iters=k, relres=rnorm / torch.clamp(bnorm, min=1e-300)
    )
