"""Matrix-free structured-grid hex FEM operator: the plain PyTorch forms.

`K(x) @ u` without an assembled matrix (reference AssembleStiffnessMatrix +
MatMult, LinearElasticity.cc:487-549, 204):

    1. *gather*  — 8 shifted slices collect each element's corner dofs into
       an ``(ex, ey, ez, 8*dof)`` tensor,
    2. *matmul*  — one ``(nelem, 8*dof) x (8*dof, 8*dof)`` product against
       the element matrix with the per-element SIMP scale applied first,
    3. *scatter* — 8 shifted slice additions accumulate corner forces back
       to nodes.

These are the plain versions that the hand-written kernels are held to:
`apply_hex_operator` for K1 (ops/blocked_hex.py) and
`element_quadratic_form` for K2 (ops/quadform.py).  The diagonal and
absolute-row-sum stencils are the multigrid setup's and stay plain torch.

Nodal fields are ``(nx, ny, nz, dof)``, element fields ``(ex, ey, ez)``,
the layout of the JAX package's functions of the same names.
"""

from __future__ import annotations

import torch

from topopt_in_petsc_tpu_torch.grid import CORNER_OFFSETS


def _corner_slice(u: torch.Tensor, corner: int) -> torch.Tensor:
    """Element-grid view of nodal field `u` at a given hex corner."""
    ox, oy, oz = CORNER_OFFSETS[corner]
    ex, ey, ez = u.shape[0] - 1, u.shape[1] - 1, u.shape[2] - 1
    return u[ox : ox + ex, oy : oy + ey, oz : oz + ez]


def gather_element_dofs(u: torch.Tensor) -> torch.Tensor:
    """(nx, ny, nz, dof) nodal field -> (ex, ey, ez, 8*dof) element dofs,
    corner-major, dof-minor (reference edof order, LinearElasticity.cc:263)."""
    return torch.cat([_corner_slice(u, c) for c in range(8)], dim=-1)


def scatter_element_dofs(fe: torch.Tensor, nn) -> torch.Tensor:
    """(ex, ey, ez, 8*dof) element values -> (nx, ny, nz, dof) nodal sum;
    the adjoint of `gather_element_dofs`."""
    ex, ey, ez, k = fe.shape
    dof = k // 8
    out = fe.new_zeros((nn[0], nn[1], nn[2], dof))
    for c, (ox, oy, oz) in enumerate(CORNER_OFFSETS):
        out[ox : ox + ex, oy : oy + ey, oz : oz + ez] += fe[
            ..., c * dof : (c + 1) * dof
        ]
    return out


def apply_hex_operator(
    u: torch.Tensor, scale: torch.Tensor, KE: torch.Tensor
) -> torch.Tensor:
    """Matrix-free ``K @ u`` with ``K = sum_e scale_e * (S_e^T KE S_e)``.

    u: (nx, ny, nz, dof); scale: (ex, ey, ez); KE: (8*dof, 8*dof).
    """
    ue = gather_element_dofs(u)
    fe = (ue * scale[..., None]) @ KE
    return scatter_element_dofs(fe, u.shape[:3])


def _corner_stencil(scale, per_corner, nn):
    """sum over corners c of scale placed at the nodes n = e + off_c,
    times the (dof,) row `per_corner[c]`."""
    ex, ey, ez = scale.shape
    dof = per_corner.shape[1]
    out = scale.new_zeros((nn[0], nn[1], nn[2], dof))
    for c, (ox, oy, oz) in enumerate(CORNER_OFFSETS):
        out[ox : ox + ex, oy : oy + ey, oz : oz + ez] += (
            scale[..., None] * per_corner[c]
        )
    return out


def hex_operator_diagonal(scale: torch.Tensor, KE: torch.Tensor, nn):
    """diag(K) as an (nx, ny, nz, dof) field (for Jacobi/Chebyshev)."""
    dof = KE.shape[0] // 8
    return _corner_stencil(scale, torch.diagonal(KE).reshape(8, dof), nn)


def hex_operator_absrowsum(scale: torch.Tensor, KE: torch.Tensor, nn):
    """sum_j |K_ij| as an (nx, ny, nz, dof) field — the Gershgorin bound
    input (solvers/chebyshev.gershgorin_lambda_max).  Requires
    scale >= 0 (SIMP scales are)."""
    dof = KE.shape[0] // 8
    return _corner_stencil(
        scale, torch.sum(torch.abs(KE), dim=1).reshape(8, dof), nn
    )


def element_quadratic_form(u: torch.Tensor, KE: torch.Tensor) -> torch.Tensor:
    """Per-element ``q_e = u_e^T KE u_e`` -> (ex, ey, ez): the uKu loop of
    the objective and its sensitivity (LinearElasticity.cc:405-424)."""
    ue = gather_element_dofs(u)
    return torch.sum((ue @ KE) * ue, dim=-1)
