"""Multigrid transfers on the structured hex grid.

Separable trilinear interpolation (the reference's DMCreateInterpolation,
LinearElasticity.cc:704), restriction as its exact adjoint (R = P^T), and
2x2x2 averaging of element fields for the rediscretized coarse operators.

`prolong` and `restrict` act on three spatial axes of any field: the nodal
``(nx, ny, nz, dof)`` layout (axes 0-2, the default) or the resident
``(dof, nx, ny, nz)`` layout (axes 1-3).
"""

from __future__ import annotations

import torch


def _axis_slice(ndim: int, axis: int, sl: slice):
    idx = [slice(None)] * ndim
    idx[axis] = sl
    return tuple(idx)


def _interp_axis(u: torch.Tensor, axis: int) -> torch.Tensor:
    """Linear interpolation along one axis: size n -> 2n-1."""
    n = u.shape[axis]
    mid = 0.5 * (u.narrow(axis, 0, n - 1) + u.narrow(axis, 1, n - 1))
    shape = list(u.shape)
    shape[axis] = 2 * n - 1
    out = u.new_zeros(shape)
    out[_axis_slice(u.ndim, axis, slice(0, None, 2))] = u
    out[_axis_slice(u.ndim, axis, slice(1, None, 2))] = mid
    return out


def prolong(uc: torch.Tensor, axes=(0, 1, 2)) -> torch.Tensor:
    """Coarse (ncx, ncy, ncz) -> fine (2ncx-1, ...) trilinear."""
    u = uc
    for axis in axes:
        u = _interp_axis(u, axis)
    return u


def _restrict_axis(f: torch.Tensor, axis: int) -> torch.Tensor:
    """Adjoint of _interp_axis: c[i] = f[2i] + 0.5 f[2i-1] + 0.5 f[2i+1]."""
    c = f[_axis_slice(f.ndim, axis, slice(0, None, 2))].clone()
    mid = 0.5 * f[_axis_slice(f.ndim, axis, slice(1, None, 2))]
    c[_axis_slice(f.ndim, axis, slice(1, None))] += mid
    c[_axis_slice(f.ndim, axis, slice(None, -1))] += mid
    return c


def restrict(rf: torch.Tensor, axes=(0, 1, 2)) -> torch.Tensor:
    """Fine -> coarse residual transfer, exact transpose of `prolong`."""
    r = rf
    for axis in axes:
        r = _restrict_axis(r, axis)
    return r


def coarsen_cell_field(E: torch.Tensor) -> torch.Tensor:
    """2x2x2 arithmetic average of a per-element field (8-child averaging
    of the SIMP-scaled stiffness), summed x, then y, then z pairs."""
    ex, ey, ez = E.shape
    E = E.reshape(ex // 2, 2, ey, ez).sum(dim=1)
    E = E.reshape(ex // 2, ey // 2, 2, ez).sum(dim=2)
    E = E[..., 0::2] + E[..., 1::2]
    return E * 0.125
