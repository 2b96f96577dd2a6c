"""Method of Moving Asymptotes with a dual interior-point subproblem solver.

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
the m x m dual Newton system is tiny.  As in the JAX package, the working
dtype is a constructor argument: the split driver runs f64, the fused step
the field dtype (f32) with f64 sums (`precise_dots`).

The dual interior point has two forms with the same result.  The split
driver's `update` runs it as nested host loops (`_solve_dip`), one host
read per Newton step.  The fused step runs it as one flattened, predicated
trip (`dip_trips`): a Newton step while ``err > 0.9 epsi`` and fewer than
100 steps at this epsilon, else ``epsi *= 0.1``, until ``epsi <= tol``:
the JAX package's nested `while_loop`s exactly, in segments with one host
read of the loop flag after each.
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


class DIPState(NamedTuple):
    """Carry of the flattened dual interior point."""

    lam: torch.Tensor  # (m,)
    mu: torch.Tensor  # (m,)
    err: torch.Tensor  # 0-d, the last Newton step's residual
    loop: torch.Tensor  # 0-d int32, Newton steps at this epsilon
    epsi: torch.Tensor  # 0-d


class MMA:
    """m-constraint MMA over an n-dof design field of the given shape."""

    asyminit = 0.5
    asymdec = 0.7
    asyminc = 1.2

    def __init__(self, n: int, m: int, shape: Tuple[int, ...], *,
                 device: torch.device, dtype=F64, precise_dots: bool = True):
        self.n = n
        self.m = m
        self.shape = tuple(shape)
        self.device = torch.device(device)
        self.dtype = dtype
        self.precise = precise_dots
        # default subproblem penalties (MMA.cc:128-132 / TopOpt.cc:394-398)
        self.a = torch.zeros(m, dtype=dtype, device=self.device)
        self.c = torch.full((m,), 1000.0, dtype=dtype, device=self.device)
        # compared with epsilon in the working dtype, as the JAX package's
        # weakly typed Python float is
        self.tol = 1.0e-9 * math.sqrt(m + n)
        z = torch.zeros(self.shape, dtype=dtype, device=self.device)
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
        return self._movelimit_impl(x.to(self.dtype), Xmin, Xmax, movlim)

    @staticmethod
    def _movelimit_impl(x, Xmin, Xmax, movlim):
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
        advance the history.  Returns the new design (in self.dtype)."""
        s = self.state
        x_new, L, U = self._update_impl(
            x, dfdx, gx, dgdx, xmin, xmax, s.L, s.U, s.xo1, s.xo2,
            fresh_asymptotes=s.k < 2,
        )
        # the history keeps x as it was passed (f32 at the first update),
        # as the JAX package does
        self.state = MMAState(L=L, U=U, xo1=x, xo2=s.xo1, k=s.k + 1)
        return x_new

    def _update_impl(self, x, dfdx, gx, dgdx, xmin, xmax, L, U, xo1, xo2,
                     *, fresh_asymptotes: bool):
        """One subproblem from explicit history: (x_new, L, U)."""
        sub = self._subproblem(
            x, dfdx, gx, dgdx, xmin, xmax, L, U, xo1, xo2,
            fresh_asymptotes=fresh_asymptotes,
        )
        return self._solve_dip(sub), sub[0], sub[1]

    def _subproblem(self, *fields, fresh_asymptotes: bool):
        """GenSub on (x, dfdx, gx, dgdx, xmin, xmax, L, U, xo1, xo2) taken
        to the working dtype."""
        return self._gensub(*(f.to(self.dtype) for f in fields),
                            fresh_asymptotes=fresh_asymptotes)

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
                torch.where(helpvar > 0.0, self.asyminc,
                            torch.ones_like(x)),
            )
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
        """sum_i pij/(U-x) + qij/(x-L), per constraint j: (m,), summed in
        f64 when `precise`."""
        L, U, pij, qij = sub
        sdt = F64 if self.precise else self.dtype
        return torch.stack([
            torch.sum(pij[j] / (U - x) + qij[j] / (x - L), dtype=sdt)
            for j in range(self.m)
        ]).to(self.dtype)

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
        w = (PQf * df2.reshape(1, -1)).to(F64 if self.precise else self.dtype)
        Hess = (w @ PQf.to(w.dtype).T).to(self.dtype)

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
        Hess = Hess + corr * torch.eye(self.m, dtype=self.dtype,
                                       device=x.device)
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
            # solve_ex: solve's info check reads the device
            s_lam = torch.linalg.solve_ex(Hess, grad)[0]
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

    def dip_start(self) -> DIPState:
        dt, dev = self.dtype, self.c.device
        one = torch.ones((), dtype=dt, device=dev)
        return DIPState(
            lam=self.c / 2.0,
            mu=torch.ones((self.m,), dtype=dt, device=dev),
            err=one,  # carried across epsilon levels, as in the reference
            loop=torch.zeros((), dtype=torch.int32, device=dev),
            epsi=one.clone(),
        )

    def dip_active(self, d: DIPState) -> torch.Tensor:
        """0-d device flag: is the epsilon path unfinished?"""
        return d.epsi > self.tol

    def dip_trips(self, d: DIPState, sub, n: int) -> DIPState:
        """n trips of the flattened dual interior point (MMA.cc:651-688):
        a Newton step where ``err > 0.9 epsi`` and ``loop < 100``,
        otherwise ``epsi *= 0.1, loop = 0``; nothing once epsi <= tol.
        Every trip computes the Newton step and `torch.where` keeps or
        drops it."""
        for _ in range(n):
            active = self.dip_active(d)
            newton = active & (d.err > 0.9 * d.epsi) & (d.loop < 100)
            decay = active & ~newton
            lam, mu, err = self._newton_step(d.lam, d.mu, d.epsi, sub)
            d = DIPState(
                lam=torch.where(newton, lam, d.lam),
                mu=torch.where(newton, mu, d.mu),
                err=torch.where(newton, err, d.err),
                loop=torch.where(
                    newton, d.loop + 1, torch.where(decay, 0, d.loop)
                ).to(torch.int32),
                epsi=torch.where(decay, d.epsi * 0.1, d.epsi),
            )
        return d

    def dip_x(self, d: DIPState, sub) -> torch.Tensor:
        """x(lambda) of the solved dual."""
        return self._xyz_of_lambda(d.lam, sub)[0]

    def _solve_dip(self, sub):
        """Dual interior point over the epsilon path (MMA.cc:651-688) as
        nested host loops, one host read per Newton step (the split
        driver's); returns x(lambda*), that of `dip_trips` bit for bit."""
        lam = self.c / 2.0
        mu = torch.ones((self.m,), dtype=self.dtype, device=self.c.device)
        epsi = 1.0
        err = 1.0  # carried across epsilon levels, as in the reference
        while epsi > self.tol:
            loop = 0
            while err > 0.9 * epsi and loop < 100:
                lam, mu, err_t = self._newton_step(lam, mu, epsi, sub)
                err = float(err_t)
                loop += 1
            epsi *= 0.1
        return self._xyz_of_lambda(lam, sub)[0]
