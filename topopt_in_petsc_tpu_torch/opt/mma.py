"""Method of Moving Asymptotes with a dual interior-point subproblem solver,
always in f64.

Counterpart of the reference MMA class (MMA.{h,cc}), the distributed MMA of
Aage & Lazarov (2013), SMO 47(4):493-505:

  per Update (MMA.cc:499-518):
    1. GenSub (MMA.cc:522-649): moving asymptotes L/U via the oscillation
       heuristic, subproblem bounds alpha/beta, separable convex
       approximation coefficients p0/q0/pij/qij, constraint constants b.
    2. Solve the dual over lambda in R^m with a dense interior-point Newton
       method (MMA.cc:651-946) over a decreasing epsilon path
       1 -> 1e-9 sqrt(m+n).

O(n) work is elementwise over the design tensor with m-sized reductions;
the m x m dual Newton system is tiny.  The Newton loops run on the host,
one sync per step for the convergence test.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

F64 = torch.float64


class MMAState(NamedTuple):
    """Persistent optimizer state (the restart set, TopOpt.cc:523)."""

    L: torch.Tensor  # lower asymptotes, design shape
    U: torch.Tensor  # upper asymptotes
    xo1: torch.Tensor  # design at iteration k-1
    xo2: torch.Tensor  # design at iteration k-2
    k: int  # GenSub call count


class MMA:
    """m-constraint MMA over an n-dof design field of the given shape."""

    asyminit = 0.5
    asymdec = 0.7
    asyminc = 1.2

    def __init__(self, n: int, m: int, shape: Tuple[int, ...], *,
                 device: torch.device):
        self.n = n
        self.m = m
        self.shape = tuple(shape)
        self.device = torch.device(device)
        # default subproblem penalties (MMA.cc:128-132 / TopOpt.cc:394-398)
        self.a = torch.zeros(m, dtype=F64, device=self.device)
        self.c = torch.full((m,), 1000.0, dtype=F64, device=self.device)
        z = torch.zeros(self.shape, dtype=F64, device=self.device)
        self.state = MMAState(L=z, U=z, xo1=z, xo2=z, k=0)

    # -------------------------------------------------------------- #
    # Public API mirroring MMA.h:44-73

    @classmethod
    def from_restart(cls, n, m, shape, k, xo1, xo2, U, L, *, device):
        """Restart constructor (MMA.cc:22-106); the history goes to f64."""
        mma = cls(n, m, shape, device=device)
        if k < 3:
            print("NOT A LEGAL RESTART POINT (k<3): EXPECT BREAKDOWN")
        as64 = lambda v: torch.as_tensor(v, dtype=F64, device=mma.device)  # noqa: E731
        mma.state = MMAState(
            L=as64(L), U=as64(U), xo1=as64(xo1), xo2=as64(xo2), k=int(k)
        )
        return mma

    def restart_vectors(self):
        """Restart export (MMA.cc:319-359): (xo1, xo2, U, L)."""
        s = self.state
        return s.xo1, s.xo2, s.U, s.L

    def set_outer_movelimit(self, Xmin, Xmax, movlim, x):
        """SetOuterMovelimit (MMA.cc:386-405): returns (xmin, xmax)."""
        x = x.to(F64)
        xmax = torch.clamp(x + movlim, max=Xmax)
        xmin = torch.clamp(x - movlim, min=Xmin)
        return xmin, xmax

    def design_change(self, x, xold):
        """DesignChange (MMA.cc:407-426): inf-norm of x - xold.
        Returns (ch, x) — the caller stores x as the new xold."""
        ch = torch.max(torch.abs(x.to(F64) - xold.to(F64)))
        return float(ch), x

    def update(self, x, dfdx, gx, dgdx, xmin, xmax):
        """Update (MMA.cc:499-518): generate + solve the subproblem,
        advance the history.  Returns the new design (f64)."""
        s = self.state
        sub = self._gensub(
            x.to(F64), dfdx.to(F64), gx.to(F64), dgdx.to(F64),
            xmin.to(F64), xmax.to(F64), s.L, s.U, s.xo1.to(F64),
            s.xo2.to(F64), fresh_asymptotes=s.k < 2,
        )
        x_new = self._solve_dip(sub)
        # the history keeps x as it was passed (f32 at the first update),
        # as the JAX package does
        self.state = MMAState(L=sub[0], U=sub[1], xo1=x, xo2=s.xo1, k=s.k + 1)
        return x_new

    # -------------------------------------------------------------- #
    # Subproblem generation (GenSub, MMA.cc:522-649)

    def _gensub(self, x, dfdx, gx, dgdx, xmin, xmax, L, U, xo1, xo2, *,
                fresh_asymptotes: bool):
        if fresh_asymptotes:
            L = x - self.asyminit * (xmax - xmin)
            U = x + self.asyminit * (xmax - xmin)
        else:
            helpvar = (x - xo1) * (xo1 - xo2)
            gamma = torch.where(
                helpvar < 0.0,
                self.asymdec,
                torch.where(helpvar > 0.0, self.asyminc, 1.0),
            ).to(F64)
            L = x - gamma * (xo1 - L)
            U = x + gamma * (U - xo1)
            xmi = torch.clamp(xmax - xmin, min=1.0e-5)
            L = torch.minimum(torch.maximum(L, x - 10.0 * xmi), x - 0.01 * xmi)
            U = torch.minimum(torch.maximum(U, x + 0.01 * xmi), x + 10.0 * xmi)

        alpha = torch.maximum(xmin, 0.9 * L + 0.1 * x)
        beta = torch.minimum(xmax, 0.9 * U + 0.1 * x)

        feps = 1.0e-6
        Ux2 = (U - x) ** 2
        xL2 = (x - L) ** 2
        reg = 0.001 * torch.abs(dfdx) + 0.5 * feps / (U - L)
        p0 = Ux2 * (torch.clamp(dfdx, min=0.0) + reg)
        q0 = xL2 * (torch.clamp(-dfdx, min=0.0) + reg)
        pij = Ux2[None] * torch.clamp(dgdx, min=0.0)
        qij = xL2[None] * torch.clamp(-dgdx, min=0.0)
        b = self._constraint_sums(x, (L, U, pij, qij)) - gx
        return L, U, alpha, beta, p0, q0, pij, qij, b

    def _constraint_sums(self, x, sub):
        """sum_i pij/(U-x) + qij/(x-L), per constraint j: (m,)."""
        L, U, pij, qij = sub
        return torch.stack([
            torch.sum(pij[j] / (U - x) + qij[j] / (x - L))
            for j in range(self.m)
        ])

    # -------------------------------------------------------------- #
    # Dual interior point (SolveDIP, MMA.cc:651-688)

    def _xyz_of_lambda(self, lam, sub):
        """x(lambda), y(lambda), z(lambda) (MMA.cc:690-740)."""
        L, U, alpha, beta, p0, q0, pij, qij, b = sub
        lam = torch.clamp(lam, min=0.0)
        y = torch.clamp(lam - self.c, min=0.0)
        lamai = torch.sum(lam * self.a)
        z = torch.clamp(10.0 * (lamai - 1.0), min=0.0)  # a0 = 1.0
        pjlam = p0 + torch.tensordot(lam, pij, dims=1)
        qjlam = q0 + torch.tensordot(lam, qij, dims=1)
        sp = torch.sqrt(pjlam)
        sq = torch.sqrt(qjlam)
        x = (sp * L + sq * U) / (sp + sq)
        x = torch.minimum(torch.maximum(x, alpha), beta)
        return x, y, z, lam

    def _dual_grad(self, x, y, z, sub):
        """(MMA.cc:742-777)."""
        L, U, alpha, beta, p0, q0, pij, qij, b = sub
        g = self._constraint_sums(x, (L, U, pij, qij))
        return g - b - self.a * z - y

    def _dual_hess(self, x, lam, mu, sub):
        """(MMA.cc:779-880)."""
        L, U, alpha, beta, p0, q0, pij, qij, b = sub
        lam = torch.clamp(lam, min=0.0)
        pjlam = p0 + torch.tensordot(lam, pij, dims=1)
        qjlam = q0 + torch.tensordot(lam, qij, dims=1)
        Ux = U - x
        xL = x - L
        PQ = pij / Ux[None] ** 2 - qij / xL[None] ** 2  # (m, ...)
        df2 = -1.0 / (2.0 * pjlam / Ux**3 + 2.0 * qjlam / xL**3)
        sp = torch.sqrt(pjlam)
        sq = torch.sqrt(qjlam)
        xp = (sp * L + sq * U) / (sp + sq)
        df2 = torch.where((xp < alpha) | (xp > beta), 0.0, df2)

        PQf = PQ.reshape(self.m, -1)
        Hess = (PQf * df2.reshape(1, -1)) @ PQf.T

        lamai = torch.sum(lam * self.a)
        diag_corr = torch.where(lam > self.c, -1.0, 0.0) - mu / torch.clamp(
            lam, min=1e-300
        )
        Hess = Hess + torch.diag(diag_corr)
        Hess = Hess + torch.where(
            lamai > 0.0, -10.0 * torch.outer(self.a, self.a), 0.0
        )
        # diagonal regularization (MMA.cc:856-866)
        corr = 1e-4 * torch.trace(Hess) / self.m
        corr = torch.where(-corr < 1.0e-7, -1.0e-7, corr)
        Hess = Hess + corr * torch.eye(self.m, dtype=F64, device=x.device)
        return Hess, lam

    def _dual_residual(self, x, y, z, lam, mu, epsi, sub):
        """(MMA.cc:902-946): inf-norm of the 2m dual KKT residuals."""
        L, U, alpha, beta, p0, q0, pij, qij, b = sub
        res1 = self._constraint_sums(x, (L, U, pij, qij))
        res1 = res1 - b - self.a * z - y + mu
        res2 = mu * lam - epsi
        return torch.maximum(
            torch.max(torch.abs(res1)), torch.max(torch.abs(res2))
        )

    def _newton_step(self, lam, mu, epsi, sub):
        x, y, z, lam = self._xyz_of_lambda(lam, sub)
        grad = self._dual_grad(x, y, z, sub)
        grad = -grad - epsi / lam
        Hess, lam = self._dual_hess(x, lam, mu, sub)
        if self.m == 1:
            s_lam = grad / Hess[0, 0]
        else:
            s_lam = torch.linalg.solve(Hess, grad)
        s_mu = -mu + epsi / lam - s_lam * mu / lam
        # line search (MMA.cc:882-900)
        theta = torch.clamp(
            torch.maximum(
                torch.max(-1.01 * s_lam / lam), torch.max(-1.01 * s_mu / mu)
            ),
            min=1.005,
        )
        step = 1.0 / theta
        lam = lam + step * s_lam
        mu = mu + step * s_mu
        x, y, z, lam_cl = self._xyz_of_lambda(lam, sub)
        err = self._dual_residual(x, y, z, lam_cl, mu, epsi, sub)
        return lam, mu, err

    def _solve_dip(self, sub):
        """Dual interior point over the epsilon path (MMA.cc:651-688);
        returns x(lambda*)."""
        lam = self.c / 2.0
        mu = torch.ones((self.m,), dtype=F64, device=self.c.device)
        tol = 1.0e-9 * math.sqrt(self.m + self.n)
        epsi = 1.0
        err = 1.0  # carried across epsilon levels, as in the reference
        while epsi > tol:
            loop = 0
            while err > 0.9 * epsi and loop < 100:
                lam, mu, err_t = self._newton_step(lam, mu, epsi, sub)
                err = float(err_t)
                loop += 1
            epsi *= 0.1
        return self._xyz_of_lambda(lam, sub)[0]
