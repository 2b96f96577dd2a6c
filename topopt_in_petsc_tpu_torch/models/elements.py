"""Reference element matrices for trilinear (Q1 / Hex8) elements.

Setup-time, host-side numpy in float64.  These replace the reference's
per-element closed forms:

- `hex8_stiffness`: the 24x24 elasticity element stiffness the reference
  computes in LinearElasticity::Hex8Isoparametric (LinearElasticity.cc:841-998)
  — full 2x2x2 Gauss integration of B^T C B with E=1 (the elasticity modulus
  is applied later by SIMP scaling, LinearElasticity.cc:519).
- `helmholtz_element_matrices`: the 8x8 Helmholtz operator (R^2 * grad-grad +
  mass) and 8x1 element-to-node averaging map of the PDE filter, which the
  reference carries as a symbolically pre-integrated closed form
  (PDEFilter.cc:472-576).  Here both come from the same quadrature machinery;
  2-point Gauss is exact for these polynomial integrands.

Local corner ordering follows grid.CORNER_OFFSETS (== the reference's hex
node ordering).  Voigt strain order is [exx, eyy, ezz, gxy, gyz, gxz],
matching the alpha-matrix construction at LinearElasticity.cc:906-921.
"""

from __future__ import annotations

import numpy as np

from topopt_in_petsc_tpu_torch.grid import CORNER_OFFSETS

# Corner parametric signs: offset 0 -> xi=-1, offset 1 -> xi=+1.
_SIGNS = 2.0 * np.array(CORNER_OFFSETS, dtype=np.float64) - 1.0  # (8, 3)

_GP_1D = np.array([-1.0, 1.0]) / np.sqrt(3.0)  # 2-pt Gauss, weights 1


def _gauss_points(reduced: bool = False) -> np.ndarray:
    """(ngp, 3) Gauss points; 2x2x2 full or single-point reduced."""
    if reduced:
        return np.zeros((1, 3))
    g = np.stack(np.meshgrid(_GP_1D, _GP_1D, _GP_1D, indexing="ij"), -1)
    return g.reshape(-1, 3)


def shape_functions(pts: np.ndarray) -> np.ndarray:
    """Trilinear shape functions N at parametric points.  (npts, 8)."""
    pts = np.atleast_2d(pts)
    terms = 1.0 + pts[:, None, :] * _SIGNS[None, :, :]  # (npts, 8, 3)
    return 0.125 * terms.prod(axis=-1)


def shape_gradients(pts: np.ndarray) -> np.ndarray:
    """dN/d(xi,eta,zeta) at parametric points.  (npts, 8, 3)."""
    pts = np.atleast_2d(pts)
    terms = 1.0 + pts[:, None, :] * _SIGNS[None, :, :]  # (npts, 8, 3)
    out = np.empty((pts.shape[0], 8, 3))
    for a in range(3):
        others = [b for b in range(3) if b != a]
        out[:, :, a] = (
            0.125 * _SIGNS[None, :, a] * terms[:, :, others].prod(axis=-1)
        )
    return out


def isotropic_C(nu: float) -> np.ndarray:
    """6x6 isotropic constitutive matrix with E=1
    (LinearElasticity.cc:887-895)."""
    lam = nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = 1.0 / (2.0 * (1.0 + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[np.arange(3), np.arange(3)] = lam + 2.0 * mu
    C[np.arange(3, 6), np.arange(3, 6)] = mu
    return C


def hex8_stiffness(
    dx: float, dy: float, dz: float, nu: float, reduced: bool = False
) -> np.ndarray:
    """24x24 element stiffness for an axis-aligned box hex, E=1.

    dof ordering: (node0_ux, node0_uy, node0_uz, node1_ux, ...), node order
    per grid.CORNER_OFFSETS.  Equivalent to Hex8Isoparametric
    (LinearElasticity.cc:841-998) on the box element X/Y/Z of
    LinearElasticity.cc:118-120.
    """
    h = np.array([dx, dy, dz])
    C = isotropic_C(nu)
    gps = _gauss_points(reduced)
    detJ = h.prod() / 8.0
    weight = detJ * (8.0 if reduced else 1.0)

    grads = shape_gradients(gps)  # parametric (ngp, 8, 3)
    # Axis-aligned box: J = diag(h/2), so d/dx = (2/h) * d/dxi.
    grads = grads * (2.0 / h)[None, None, :]  # physical gradients

    ke = np.zeros((24, 24))
    # Voigt rows: (component index paired with derivative axis)
    # exx=(x,0) eyy=(y,1) ezz=(z,2) gxy=(0,1)+(1,0) gyz=(1,2)+(2,1)
    # gxz=(0,2)+(2,0)
    for g in grads:
        B = np.zeros((6, 24))
        for node in range(8):
            gx, gy, gz = g[node]
            col = 3 * node
            B[0, col + 0] = gx
            B[1, col + 1] = gy
            B[2, col + 2] = gz
            B[3, col + 0] = gy
            B[3, col + 1] = gx
            B[4, col + 1] = gz
            B[4, col + 2] = gy
            B[5, col + 0] = gz
            B[5, col + 2] = gx
        ke += weight * (B.T @ C @ B)
    return ke


def hex8_laplace_mass(dx: float, dy: float, dz: float):
    """(8x8 Laplace stiffness, 8x8 mass) for the scalar Q1 box element."""
    h = np.array([dx, dy, dz])
    gps = _gauss_points()
    detJ = h.prod() / 8.0
    N = shape_functions(gps)  # (8gp, 8)
    G = shape_gradients(gps) * (2.0 / h)[None, None, :]  # (8gp, 8, 3)
    M = detJ * np.einsum("gi,gj->ij", N, N)
    K = detJ * np.einsum("gia,gja->ij", G, G)
    return K, M


def octant_transfer_matrices(dof: int) -> np.ndarray:
    """T_p (8, 8*dof, 8*dof): coarse-element corner dofs -> fine corner
    dofs of child octant p, via trilinear embedding (nested Q1 spaces).

    Child octant p sits at offset off_p in {0,1}^3 inside the coarse
    element; its corner a lies at coarse-local coordinates
    (off_p + off_a)/2, and T_p rows are the trilinear weights of the 8
    coarse corners at that point.
    """
    T = np.zeros((8, 8 * dof, 8 * dof))
    for p, op in enumerate(CORNER_OFFSETS):
        for a, oa in enumerate(CORNER_OFFSETS):
            pos = (np.array(op) + np.array(oa)) / 2.0  # in [0,1]^3
            for b, ob in enumerate(CORNER_OFFSETS):
                w = 1.0
                for ax in range(3):
                    w *= pos[ax] if ob[ax] == 1 else 1.0 - pos[ax]
                for d in range(dof):
                    T[p, a * dof + d, b * dof + d] = w
    return T


def galerkin_octant_matrices(KE_child: np.ndarray, dof: int) -> np.ndarray:
    """KEp (8, 8*dof, 8*dof) = T_p^T KE_child T_p.

    The exact Galerkin coarse element operator for nested trilinear
    spaces:  P^T K_h P = sum_C S_C^T ( sum_p E_child_p KEp ) S_C  — the
    coarse stiffness is a per-element combination of these 8 *constant*
    matrices weighted by the 8 child coefficients (replacing the
    reference's distributed RAP triple product, PC_MG_GALERKIN_BOTH,
    LinearElasticity.cc:702, with zero extra memory).
    """
    T = octant_transfer_matrices(dof)
    return np.stack([T[p].T @ KE_child @ T[p] for p in range(8)])


def helmholtz_element_matrices(dx: float, dy: float, dz: float, R: float):
    """PDE-filter element operator KF = R^2 * Laplace + Mass (8x8) and the
    node<-element averaging weights TF (8,) == 1/8.

    Matches the closed-form PDEFilterMatrix (PDEFilter.cc:472-576); the
    element-volume scaling of the RHS (PDEFilter.cc:202) lives in the caller.
    """
    K, M = hex8_laplace_mass(dx, dy, dz)
    KF = (R * R) * K + M
    TF = np.full((8,), 0.125)
    return KF, TF
