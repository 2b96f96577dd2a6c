"""One update of the Method of Moving Asymptotes with one constraint, in
plain float64 PyTorch (Svanberg 1987; the subproblem of the reference
code's MMA.cc GenSub, with its default constants).

The subproblem is made as GenSub makes it: the asymptotes by the
oscillation rule with asyminit 0.5, asymdec 0.7, asyminc 1.2 and the
robust bounds of type 0, the bounds alpha and beta, the convex
approximation p0, q0, p1, q1 with feps = 1e-6, and the penalties a = 0,
c = 1000.  Its dual is then solved exactly: with one constraint the
dual's stationary point is the root of a monotone function of lambda,
found here by bisection to the last bit, where the reference code runs
an interior point to epsilon = 1e-9 sqrt(n + 1).
"""

from __future__ import annotations

import torch

F64 = torch.float64
ASYMINIT, ASYMDEC, ASYMINC = 0.5, 0.7, 1.2
FEPS = 1.0e-6
C = 1000.0


def subproblem(x, dfdx, gx, dgdx, xmin, xmax, L, U, xo1, xo2, fresh):
    """(L, U, alpha, beta, p0, q0, p1, q1, b) of GenSub, in float64."""
    x, dfdx, dgdx, xmin, xmax, L, U, xo1, xo2 = (
        t.to(F64) for t in (x, dfdx, dgdx, xmin, xmax, L, U, xo1, xo2))
    if fresh:
        L = x - ASYMINIT * (xmax - xmin)
        U = x + ASYMINIT * (xmax - xmin)
    else:
        osc = (x - xo1) * (xo1 - xo2)
        gamma = torch.where(osc < 0, ASYMDEC,
                            torch.where(osc > 0, ASYMINC, 1.0))
        L = x - gamma * (xo1 - L)
        U = x + gamma * (U - xo1)
        span = torch.clamp(xmax - xmin, min=1.0e-5)
        L = torch.minimum(torch.maximum(L, x - 10.0 * span), x - 0.01 * span)
        U = torch.minimum(torch.maximum(U, x + 0.01 * span), x + 10.0 * span)
    alpha = torch.maximum(xmin, 0.9 * L + 0.1 * x)
    beta = torch.minimum(xmax, 0.9 * U + 0.1 * x)
    ux2, xl2 = (U - x) ** 2, (x - L) ** 2
    reg = 0.001 * torch.abs(dfdx) + 0.5 * FEPS / (U - L)
    p0 = ux2 * (torch.clamp(dfdx, min=0.0) + reg)
    q0 = xl2 * (torch.clamp(-dfdx, min=0.0) + reg)
    p1 = ux2 * torch.clamp(dgdx, min=0.0)
    q1 = xl2 * torch.clamp(-dgdx, min=0.0)
    b = torch.sum(p1 / (U - x) + q1 / (x - L)) - float(gx)
    return L, U, alpha, beta, p0, q0, p1, q1, b


def _x_of(lam, sub):
    L, U, alpha, beta, p0, q0, p1, q1, _ = sub
    sp = torch.sqrt(p0 + lam * p1)
    sq = torch.sqrt(q0 + lam * q1)
    return torch.clamp((sp * L + sq * U) / (sp + sq), alpha, beta)


def _dual_grad(lam, sub):
    """d(dual)/d(lambda) = g(x(lambda)) - b - y(lambda): decreasing."""
    L, U, _, _, _, _, p1, q1, b = sub
    x = _x_of(lam, sub)
    g = torch.sum(p1 / (U - x) + q1 / (x - L)) - b
    return float(g) - max(lam - C, 0.0)


def update(x, dfdx, gx, dgdx, xmin, xmax, L, U, xo1, xo2, fresh=False):
    """(new design, L, U) of one MMA update, in float64."""
    sub = subproblem(x, dfdx, gx, dgdx, xmin, xmax, L, U, xo1, xo2, fresh)
    lo, hi = 0.0, 1.0
    if _dual_grad(lo, sub) <= 0.0:
        return _x_of(0.0, sub), sub[0], sub[1]
    while _dual_grad(hi, sub) > 0.0:
        lo, hi = hi, 2.0 * hi
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if mid in (lo, hi):
            break
        if _dual_grad(mid, sub) > 0.0:
            lo = mid
        else:
            hi = mid
    return _x_of(0.5 * (lo + hi), sub), sub[0], sub[1]
