"""The cantilever's finite elements in plain float64 PyTorch: loads and
supports, the stiffness operator K(E) v, the element energies and the
residual of a state solution.

Nodal fields are (nx, ny, nz, dof), element fields (nx-1, ny-1, nz-1).
Every product runs over slabs of element planes along x, so that the
gathered element vectors of a 257^3 grid never live at once.
"""

from __future__ import annotations

import torch

from perfbench.reference.elements import CORNERS

F64 = torch.float64
SLAB = 16  # element planes per block


def cantilever(nn, device):
    """(load, free): the reference cantilever's nodal load, F_z = -0.001 on
    the edge x = xmax, z = zmin, halved at its two end nodes, and the mask
    of the free dofs (the wall x = xmin is clamped)."""
    nx, ny, nz = nn
    f = torch.zeros((nx, ny, nz, 3), dtype=F64, device=device)
    f[nx - 1, :, 0, 2] = -0.001
    f[nx - 1, 0, 0, 2] = -0.0005
    f[nx - 1, ny - 1, 0, 2] = -0.0005
    free = torch.ones((nx, ny, nz, 3), dtype=F64, device=device)
    free[0] = 0.0
    return f * free, free


def _gather(v, a, b):
    """(b - a, ey, ez, 8 dof) element vectors of elements a..b-1 along x."""
    ey, ez = v.shape[1] - 1, v.shape[2] - 1
    return torch.cat([v[a + ox:b + ox, oy:oy + ey, oz:oz + ez]
                      for ox, oy, oz in CORNERS], dim=-1)


def apply(v, E, ke):
    """sum_e E_e S_e^T ke S_e v: the operator of element matrix `ke`
    (8 dof x 8 dof) scaled by the element field E, on the nodal field v."""
    ke = torch.as_tensor(ke, dtype=F64, device=v.device)
    dof = v.shape[-1]
    ex, ey, ez = E.shape
    out = torch.zeros_like(v, dtype=F64)
    for a in range(0, ex, SLAB):
        b = min(a + SLAB, ex)
        fe = (_gather(v.to(F64), a, b) @ ke) * E[a:b, ..., None].to(F64)
        for c, (ox, oy, oz) in enumerate(CORNERS):
            out[a + ox:b + ox, oy:oy + ey, oz:oz + ez] += \
                fe[..., c * dof:(c + 1) * dof]
    return out


def energies(u, ke):
    """(ex, ey, ez) element energies u_e^T ke u_e of the nodal field u."""
    ke = torch.as_tensor(ke, dtype=F64, device=u.device)
    ex = u.shape[0] - 1
    parts = []
    for a in range(0, ex, SLAB):
        ue = _gather(u.to(F64), a, min(a + SLAB, ex))
        parts.append(((ue @ ke) * ue).sum(-1))
    return torch.cat(parts)


def relres(u, E, ke, f, free):
    """||A u - f|| / ||f|| for the supported system A = N K N + (I - N):
    the free dofs' residual of the equilibrium, and any displacement of a
    clamped dof."""
    r = free * (f - apply(free * u.to(F64), E, ke)) + (1.0 - free) * u
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(f))
