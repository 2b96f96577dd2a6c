"""Preconditioned (flexible) conjugate gradients.

The reference's outer Krylov is FGMRES(100) (LinearElasticity.cc:638-650);
K is SPD after the symmetric Dirichlet treatment (cc:530-538), so with an
SPD multigrid preconditioner CG applies.  The flexible (Polak-Ribiere)
variant is the default; it tolerates the slight nonstationarity of a CG
coarse-level solve, the robustness role FGMRES plays in the reference.

Two forms of the same iteration:

- `pcg`, the eager loop: scalars stay 0-d device tensors, and the one
  host sync per iteration is the convergence test;
- `pcg_start` / `pcg_trips`, the predicated form: the full Krylov carry
  (`PCGState`, the JAX package's) and exactly ``n`` trips of the loop
  body, each gated on a 0-d device flag, so no trip reads the device from
  the host.  A sequence of trips gives bit for bit the x, k and relres of
  `pcg`.

`pcg_x` picks one of the two for a fixed-count solve (the V-cycle's coarse
CG): the eager loop stops at convergence, the predicated form runs every
trip.

Dot products sum f32 products in f64 when `precise_dots`.

`compress` (a dtype) stores what the iteration keeps between steps in
less precision, as the JAX package's `pcg` does with its `p_compress` and
`flex_compress` both set (the reduced-precision V-cycle's outer solve,
`BlockedElasticityMG.krylov_compress`): the carried search direction,
widened for use, so each iteration is exact CG along the rounded
direction, and the copy of ``A p`` that the flexible beta keeps across
the preconditioner.  x and r stay in the field dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

# predicated trips per segment, between two host reads of a loop's flag
# (the state solve, the PDE filter's solves and MMA's dual interior point)
SEGMENT = 8


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
    iters: int  # a 0-d int32 tensor from the predicated form
    relres: torch.Tensor  # final ||r|| / ||b||, 0-d


class PCGState(NamedTuple):
    """The full Krylov carry: trips from it continue the same solve."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor  # in `compress` when given
    rz: torch.Tensor
    rnorm: torch.Tensor
    bnorm: torch.Tensor
    k: torch.Tensor  # 0-d int32


def _identity(r):
    return r


def _default_dot(dot, precise_dots):
    if dot is None:
        return lambda a, c: _dot(a, c, precise_dots)
    return dot


def pcg_start(A, b, x0, M=None, *, precise_dots: bool = True,
              dot: Optional[Callable] = None,
              compress=None) -> PCGState:
    """The carry before the first iteration, from the initial guess x0."""
    M = M or _identity
    dot = _default_dot(dot, precise_dots)
    r = b - A(x0)
    z = M(r)
    rz = dot(r, z)
    bnorm = torch.sqrt(dot(b, b))
    rnorm = torch.sqrt(dot(r, r))
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    p = z if compress is None else z.to(compress)
    return PCGState(x0, r, p, rz, rnorm, bnorm, k)


def _tol(bnorm, rtol, atol):
    return torch.clamp(rtol * bnorm, min=atol)


def _body(A, M, s: PCGState, flexible, dot, compress=None):
    """One iteration from carry s: (x, r, p, rz, rnorm).  alpha and beta
    are rounded to the field dtype before use, as in the JAX package."""
    vdt = s.x.dtype
    p = s.p.to(vdt)
    Ap = A(p)
    pAp = dot(p, Ap)
    alpha = (s.rz / pAp).to(vdt)
    x = s.x + alpha * p
    r = s.r - alpha * Ap
    if flexible and compress is not None:
        Ap = Ap.to(compress)
    z = M(r)
    if flexible:
        beta_num = -alpha * dot(z, Ap.to(z.dtype))
    else:
        beta_num = dot(z, r)
    rz = dot(r, z)
    beta = (beta_num / s.rz).to(vdt)
    p = z + beta * p
    if compress is not None:
        p = p.to(compress)
    rnorm = torch.sqrt(dot(r, r))
    return x, r, p, rz, rnorm


def pcg_active(s: PCGState, *, rtol: float, atol: float = 1e-50,
               maxiter: int) -> torch.Tensor:
    """0-d device flag: does the loop take another iteration?"""
    return (s.k < maxiter) & (s.rnorm > _tol(s.bnorm, rtol, atol))


def pcg_trips(A, s: PCGState, M=None, n: int = 1, *, rtol: float,
              atol: float = 1e-50, maxiter: int, flexible: bool = True,
              precise_dots: bool = True,
              dot: Optional[Callable] = None,
              compress=None) -> PCGState:
    """Exactly n trips of the loop body.  A trip whose flag
    ``(k < maxiter) & (rnorm > tol)`` is false keeps the carry: x, r, p,
    rz and rnorm are gated with `torch.where`, so a NaN of a discarded
    trip (0/0 after exact convergence) never leaks."""
    M = M or _identity
    dot = _default_dot(dot, precise_dots)
    tol = _tol(s.bnorm, rtol, atol)
    for _ in range(n):
        active = (s.k < maxiter) & (s.rnorm > tol)
        new = _body(A, M, s, flexible, dot, compress)
        s = PCGState(
            *(torch.where(active, v, old) for v, old in zip(new, s[:5])),
            s.bnorm, s.k + active,
        )
    return s


def pcg_result(s: PCGState) -> CGResult:
    return CGResult(
        x=s.x, iters=s.k, relres=s.rnorm / torch.clamp(s.bnorm, min=1e-300)
    )


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
    compress=None,
) -> CGResult:
    """Solve A x = b with preconditioned CG from a nonzero initial guess;
    converged when the true residual 2-norm falls to rtol * ||b||
    (reference solver contract, LinearElasticity.cc:619-647).

    Flexible (Polak-Ribiere) beta is z.(r_new - r_old) = -alpha * z.Ap.
    """
    M = M or _identity
    dot = _default_dot(dot, precise_dots)
    s = pcg_start(A, b, x0, M, dot=dot, compress=compress)
    tol = _tol(s.bnorm, rtol, atol)
    k = 0
    while k < maxiter and bool(s.rnorm > tol):
        s = PCGState(*_body(A, M, s, flexible, dot, compress), s.bnorm,
                     s.k)
        k += 1
    return pcg_result(s)._replace(iters=k)


def pcg_x(A, b, x0, M=None, *, predicated: bool, maxiter: int,
          **kw) -> torch.Tensor:
    """x of `pcg`, or, when `predicated`, of `maxiter` predicated trips:
    the same x bit for bit with no host read, at the cost of running every
    trip (a V-cycle's coarse solve inside the fused step's segments)."""
    if not predicated:
        return pcg(A, b, x0, M, maxiter=maxiter, **kw).x
    dot = _default_dot(kw.pop("dot", None), kw.pop("precise_dots", True))
    s = pcg_start(A, b, x0, M, dot=dot)
    return pcg_trips(A, s, M, maxiter, maxiter=maxiter, dot=dot, **kw).x
