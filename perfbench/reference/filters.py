"""The design filters of the reference code in plain float64 PyTorch.

- The density filter (Filter.cc, filter 1): x~ = (H x) / Hs with hat
  weights max(0, rmin - dist) between element centres over a box
  stencil, and Hs = H 1, so the stencil is cut at the domain's faces.
  H runs as a zero-padded linear convolution by FFT; its chain rule is
  H^T (g / Hs) = H (g / Hs), H being symmetric.
- The Helmholtz PDE filter (PDEFilter.cc, filter 2): (R^2 K + M) u = T x
  with R = rmin / (2 sqrt 3), T spreading vol_e x_e / 8 to the eight
  corners, x~ = T^T u (the mean of the corners), solved here by Jacobi
  preconditioned CG to a relative residual of 1e-12; it is
  self-adjoint, so it filters the sensitivities the same way.  The
  design's x~ is clipped to [0, 1].
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import fem
from perfbench.reference.elements import CORNERS, helmholtz_kf

F64 = torch.float64


def _smooth(n: int) -> int:
    """The least 2^a 3^b 5^c >= n (a fast FFT length)."""
    m = n
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


class DensityFilter:
    """H x / Hs and its chain rule on an element grid of edges h."""

    def __init__(self, ne, h, rmin: float, device):
        nn = [n + 1 for n in ne]
        s = max(math.ceil(rmin / a) - 1 for a in h)
        s = max(min(s, *[(n - 1) // 2 for n in nn]), 0)
        idx = np.arange(-s, s + 1, dtype=np.float64)
        d = np.sqrt(sum(g ** 2 for g in np.meshgrid(
            idx * h[0], idx * h[1], idx * h[2], indexing="ij")))
        w = np.where(d < rmin, rmin - d, 0.0)
        self.ne = tuple(ne)
        self.full = tuple(_smooth(n + 2 * s) for n in ne)
        k = torch.zeros(self.full, dtype=F64, device=device)
        k[:2 * s + 1, :2 * s + 1, :2 * s + 1] = torch.as_tensor(w)
        self.spectrum = torch.fft.rfftn(torch.roll(k, (-s, -s, -s),
                                                   (0, 1, 2)))
        self.Hs = self._conv(torch.ones(self.ne, dtype=F64, device=device))

    def _conv(self, x):
        pad = []
        for n, m in zip(reversed(self.ne), reversed(self.full)):
            pad += [0, m - n]
        y = torch.fft.irfftn(torch.fft.rfftn(F.pad(x.to(F64), pad))
                             * self.spectrum, s=self.full)
        ex, ey, ez = self.ne
        return y[:ex, :ey, :ez].contiguous()

    def __call__(self, x):
        return self._conv(x) / self.Hs

    def chain(self, g):
        return self._conv(g.to(F64) / self.Hs)


class PDEFilter:
    """T^T (R^2 K + M)^-1 T on an element grid of edges h."""

    RTOL = 1e-12
    MAXIT = 5000

    def __init__(self, ne, h, rmin: float, device, kf_dtype=torch.float64):
        self.ne = tuple(ne)
        self.nn = tuple(n + 1 for n in ne)
        kf = helmholtz_kf(h, rmin / (2.0 * math.sqrt(3.0)))
        self.kf = torch.as_tensor(kf).to(kf_dtype).to(F64).numpy()
        self.vol = float(np.prod(h))
        self.ones = torch.ones(self.ne, dtype=F64, device=device)
        diag = np.diag(np.diag(self.kf))
        self.diag = fem.apply(torch.ones((*self.nn, 1), dtype=F64,
                                         device=device), self.ones, diag)
        self.iters = 0

    def _A(self, v):
        return fem.apply(v, self.ones, self.kf)

    def _solve(self, b):
        x = torch.zeros_like(b)
        r = b.clone()
        z = r / self.diag
        p = z.clone()
        rz = torch.sum(r * z)
        tol = self.RTOL * torch.linalg.vector_norm(b)
        for k in range(self.MAXIT):
            if torch.linalg.vector_norm(r) <= tol:
                break
            q = self._A(p)
            alpha = rz / torch.sum(p * q)
            x += alpha * p
            r -= alpha * q
            z = r / self.diag
            rz_new = torch.sum(r * z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        else:
            raise RuntimeError("the reference PDE filter did not converge")
        self.iters = k
        return x

    def _filter(self, x):
        ex, ey, ez = self.ne
        b = torch.zeros((*self.nn, 1), dtype=F64, device=x.device)
        xe = (self.vol / 8.0) * x.to(F64)[..., None]
        for ox, oy, oz in CORNERS:
            b[ox:ox + ex, oy:oy + ey, oz:oz + ez] += xe
        u = self._solve(b)[..., 0]
        return sum(u[ox:ox + ex, oy:oy + ey, oz:oz + ez]
                   for ox, oy, oz in CORNERS) / 8.0

    def __call__(self, x):
        return torch.clamp(self._filter(x), 0.0, 1.0)

    def chain(self, g):
        return self._filter(g)


def make_filter(kind: int, ne, h, rmin: float, device,
                kf_dtype=torch.float64):
    """The filter of `-filter kind`: 1 density, 2 PDE (its element matrix
    stored in `kf_dtype`)."""
    if kind == 1:
        return DensityFilter(ne, h, rmin, device)
    if kind == 2:
        return PDEFilter(ne, h, rmin, device, kf_dtype)
    raise ValueError(f"no reference for -filter {kind}")
