"""Design-field regularization: density/sensitivity filters, Heaviside
projection, beta continuation, discreteness measure.

Counterpart of the reference Filter class (Filter.{h,cc}).  The reference
assembles a sparse convolution matrix H with hat weights max(0, R - dist)
over a box stencil and a row-sum normalization Hs (Filter.cc:324-448); here
H is a 3D convolution with zero padding (ops/conv_filter.py), and Hs is
the convolution of ones, which reproduces the reference's boundary
truncation.

filterType follows TopOpt.cc:125: 0 = sensitivity filter, 1 = density
filter (default), 2 = the Helmholtz PDE filter (opt/pde_filter.py),
anything else = no filtering.
"""

from __future__ import annotations

import math
import sys
from typing import Tuple

import numpy as np
import torch

from topopt_in_petsc_tpu_torch.ops.conv_filter import (
    FFT_TAP_THRESHOLD,
    conv3d_direct,
    make_fft_conv,
)


def filter_stencil_halfwidth(
    R: float, h: Tuple[float, float, float], nn: Tuple[int, int, int]
) -> int:
    """Stencil half-width 'ElemConn' (Filter.cc:324-332): per-axis
    ceil(R/h)-1, maxed over axes, clamped to half the node counts."""
    s = max(
        math.ceil(R / h[0]) - 1,
        math.ceil(R / h[1]) - 1,
        math.ceil(R / h[2]) - 1,
    )
    s = min(s, (nn[0] - 1) // 2, (nn[1] - 1) // 2, (nn[2] - 1) // 2)
    return max(int(s), 0)


def build_filter_kernel(
    R: float, h: Tuple[float, float, float], s: int, dtype=np.float64
) -> np.ndarray:
    """(2s+1)^3 linear-hat kernel w = max(0, R - dist) between element
    centers (the H-matrix insertion loop, Filter.cc:404-440)."""
    idx = np.arange(-s, s + 1, dtype=np.float64)
    DI, DJ, DK = np.meshgrid(idx * h[0], idx * h[1], idx * h[2],
                             indexing="ij")
    dist = np.sqrt(DI**2 + DJ**2 + DK**2)
    w = np.where(dist < R, R - dist, 0.0)
    return w.astype(dtype)


def _tanh(v):
    """tanh of a host float (the split driver's beta) or of a 0-d device
    tensor (the fused step's, which never leaves the device)."""
    return torch.tanh(v) if isinstance(v, torch.Tensor) else math.tanh(v)


def smooth_projection(x, beta, eta):
    """Smoothed Heaviside (Filter.h:80-83):
    y = (tanh(b e) + tanh(b (x-e))) / (tanh(b e) + tanh(b (1-e)))."""
    num = _tanh(beta * eta) + torch.tanh(beta * (x - eta))
    den = _tanh(beta * eta) + _tanh(beta * (1.0 - eta))
    return num / den


def smooth_projection_chainrule(x, beta, eta):
    """d(projection)/dx (Filter.h:85-88)."""
    den = _tanh(beta * eta) + _tanh(beta * (1.0 - eta))
    return beta * (1.0 - torch.tanh(beta * (x - eta)) ** 2) / den


class DesignFilter:
    """Filter::FilterProject / Gradients, dispatching on the filter type."""

    def __init__(self, cfg, grid, *, device: torch.device,
                 pde_smoke: bool = True):
        self.cfg = cfg
        self.grid = grid
        self.filterType = cfg.filter
        self.dtype = cfg.torch_dtype
        self.device = torch.device(device)
        self.pdef = None
        self.kernel = None
        self.Hs = None
        self._fft_conv = None
        if self.filterType == 2:
            # imported here: opt/pde_filter.py imports this module
            from topopt_in_petsc_tpu_torch.opt.pde_filter import PDEFilter

            self.pdef = PDEFilter(cfg, grid, device=self.device,
                                  smoke=pde_smoke)
        if self.filterType not in (0, 1):
            return
        s = filter_stencil_halfwidth(cfg.rmin, grid.h, grid.nn)
        self.stencil_halfwidth = s
        print(
            f"# Filter radius rmin = {cfg.rmin:f} results in a "
            f"stencil of {s} elements",
            file=sys.stderr,
        )
        k = build_filter_kernel(cfg.rmin, grid.h, s)
        if (2 * s + 1) ** 3 > FFT_TAP_THRESHOLD:
            self._fft_conv = make_fft_conv(
                grid.ne, k, self.dtype, self.device
            )
        else:
            self.kernel = torch.as_tensor(
                k, dtype=self.dtype, device=self.device
            )
        self.Hs = self._conv(
            torch.ones(grid.ne, dtype=self.dtype, device=self.device)
        )

    # -- convolution H (MatMult(H, x) equivalent) ----------------------- #

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        if self._fft_conv is not None:
            return self._fft_conv(x.to(self.dtype))
        return conv3d_direct(x.to(self.dtype), self.kernel)

    # -- FilterProject (Filter.cc:60-117) ------------------------------- #

    def filter_project(self, x, projection=None, beta=None, eta=None):
        """(xTilde, xPhys) of the design x."""
        cfg = self.cfg
        projection = (
            cfg.projectionFilter if projection is None else projection
        )
        beta = float(cfg.beta if beta is None else beta)
        eta = float(cfg.eta if eta is None else eta)
        x = x.to(self.dtype)
        if self.filterType == 2:
            return self.pdef.filter_project_with_projection(
                x, projection, beta, eta
            )
        return self._project_impl(x, beta, eta, projection=projection)

    def _project_impl(self, x, beta, eta, *, projection: bool):
        """FilterProject (the JAX package's `_project_impl`); beta and eta
        are host floats or 0-d device tensors.  Filters 0 and 1 read
        nothing back from the device.  Filter 2 runs the eager PDE solve
        and clips to [0, 1] without the split driver's bound-violation
        print."""
        if self.filterType == 1:
            xTilde = self._conv(x) / self.Hs
        elif self.filterType == 2:
            xTilde = torch.clamp(self.pdef.filter_project(x), 0.0, 1.0)
        else:
            xTilde = x
        if projection:
            return xTilde, smooth_projection(xTilde, beta, eta)
        return xTilde, xTilde

    def _gradients_impl(self, x, xTilde, dfdx, dgdx, beta, eta, *,
                        projection: bool):
        """Gradients (the JAX package's `_gradients_impl`), with beta and
        eta host floats or 0-d device tensors; no host reads.  Filter 2
        takes only the projection's chain rule here: the fused step runs
        its PDE solves itself."""
        if projection:
            dproj = smooth_projection_chainrule(xTilde, beta, eta)
            dfdx = dfdx * dproj
            dgdx = dgdx * dproj[None]
        if self.filterType == 0:
            # sensitivity filter: dfdx <- (H (dfdx o x)) / Hs / x
            # (Filter.cc:167-177; x floored at Xmin=0.001, TopOpt.cc:357)
            dfdx = self._conv(dfdx * x) / self.Hs / x
        elif self.filterType == 1:
            dfdx = self._conv(dfdx / self.Hs)
            dgdx = torch.stack(
                [self._conv(dgdx[j] / self.Hs)
                 for j in range(dgdx.shape[0])]
            )
        return dfdx, dgdx

    # -- Gradients (Filter.cc:120-204) ---------------------------------- #

    def gradients(self, x, xTilde, dfdx, dgdx, projection=None, beta=None,
                  eta=None):
        """Chain rule of projection and filter: returns (dfdx, dgdx) with
        respect to the design x."""
        cfg = self.cfg
        projection = (
            cfg.projectionFilter if projection is None else projection
        )
        beta = float(cfg.beta if beta is None else beta)
        eta = float(cfg.eta if eta is None else eta)
        x = x.to(self.dtype)
        dfdx = dfdx.to(self.dtype)
        dgdx = dgdx.to(self.dtype)
        if self.filterType == 2:
            return self.pdef.gradients_with_projection(
                x, xTilde.to(self.dtype), dfdx, dgdx, projection, beta, eta
            )
        return self._gradients_impl(
            x, xTilde.to(self.dtype), dfdx, dgdx, beta, eta,
            projection=projection,
        )

    # -- continuation + metrics ----------------------------------------- #

    @staticmethod
    def increase_beta(beta, betaFinal, gx, itr, ch):
        """Beta continuation (Filter.cc:268-288).  Host-side scalars."""
        changed = False
        if (ch < 0.01 or itr % 10 == 0) and beta < betaFinal and gx < 1e-6:
            changed = True
            beta = beta + 1.0 if beta < 7 else beta * 1.2
            if beta > betaFinal:
                beta = betaFinal
                changed = False
            print(f"Beta has been increased to: {beta:f}")
        return beta, changed

    def get_mnd(self, xPhys: torch.Tensor) -> float:
        """Measure of non-discreteness mean(4 x (1-x)) (Filter.cc:206-225)."""
        return float(torch.mean(4.0 * xPhys * (1.0 - xPhys)))
