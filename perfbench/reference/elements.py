"""Element matrices of the trilinear box hex, in float64 numpy: a frozen
copy of the arithmetic of the reference code (TopOpt_in_PETSc,
LinearElasticity.cc Hex8Isoparametric and PDEFilter.cc PDEFilterMatrix),
written out again here so that the benchmark's reference takes nothing
from the program under test.

Corner order (offsets in x, y, z): 0 (0,0,0), 1 (1,0,0), 2 (1,1,0),
3 (0,1,0), 4 (0,0,1), 5 (1,0,1), 6 (1,1,1), 7 (0,1,1).  The elasticity
matrix orders its 24 dofs corner-major: (corner 0 ux, uy, uz, corner 1
ux, ...).
"""

from __future__ import annotations

import numpy as np

CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
           (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))

_SIGNS = 2.0 * np.array(CORNERS, dtype=np.float64) - 1.0  # (8, 3)


def _gauss_points() -> np.ndarray:
    """The 2 x 2 x 2 Gauss points (weights 1) of the reference cube."""
    g = np.array([-1.0, 1.0]) / np.sqrt(3.0)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


def _shapes(pts):
    """Trilinear shape functions (npts, 8) and their gradients in the
    reference coordinates (npts, 8, 3)."""
    t = 1.0 + pts[:, None, :] * _SIGNS[None]  # (npts, 8, 3)
    n = 0.125 * t.prod(-1)
    grads = np.empty((pts.shape[0], 8, 3))
    for a in range(3):
        rest = [b for b in range(3) if b != a]
        grads[:, :, a] = 0.125 * _SIGNS[None, :, a] * t[:, :, rest].prod(-1)
    return n, grads


def elasticity_ke(h, nu: float) -> np.ndarray:
    """(24, 24) stiffness of a box element of edges h = (dx, dy, dz) with
    Young's modulus 1 and Poisson ratio nu: B^T C B integrated by 2 x 2 x 2
    Gauss quadrature (exact for the box)."""
    h = np.asarray(h, dtype=np.float64)
    lam = nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = 1.0 / (2.0 * (1.0 + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[range(3), range(3)] = lam + 2.0 * mu
    C[range(3, 6), range(3, 6)] = mu
    _, grads = _shapes(_gauss_points())
    grads = grads * (2.0 / h)  # physical gradients of the box
    detj = h.prod() / 8.0
    ke = np.zeros((24, 24))
    for g in grads:
        B = np.zeros((6, 24))
        for c in range(8):
            gx, gy, gz = g[c]
            # strains exx, eyy, ezz, gxy, gyz, gxz
            B[0, 3 * c] = gx
            B[1, 3 * c + 1] = gy
            B[2, 3 * c + 2] = gz
            B[3, 3 * c], B[3, 3 * c + 1] = gy, gx
            B[4, 3 * c + 1], B[4, 3 * c + 2] = gz, gy
            B[5, 3 * c], B[5, 3 * c + 2] = gz, gx
        ke += detj * (B.T @ C @ B)
    return ke


def helmholtz_kf(h, R: float) -> np.ndarray:
    """(8, 8) element matrix R^2 (grad, grad) + (N, N) of the Helmholtz
    filter on a box element of edges h."""
    h = np.asarray(h, dtype=np.float64)
    n, grads = _shapes(_gauss_points())
    grads = grads * (2.0 / h)
    detj = h.prod() / 8.0
    mass = detj * np.einsum("gi,gj->ij", n, n)
    lap = detj * np.einsum("gia,gja->ij", grads, grads)
    return R * R * lap + mass
