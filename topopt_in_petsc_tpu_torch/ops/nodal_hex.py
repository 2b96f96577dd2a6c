"""Kernels K3 and K4: the free-BC hex operator ``K(E) u`` on the nodal
layout, for the multigrid of the PDE filter (K3, dof 1) and of the nodal
elasticity solve (K4, dof 3).

Counterparts of the JAX package's `ops/pallas_hex.py` factories
`make_pallas_helmholtz_apply` (K3) and `make_pallas_hex_apply` (K4), with
their interface: ``apply(u, E)``, ``prepare_coef(E)`` and
``apply_prepared(u, eb)``.  Layout: u is a contiguous ``(nx, ny, nz,
dof)`` f32 tensor and E a contiguous ``(nx-1, ny-1, nz-1)`` f32 tensor;
the kernels (csrc/nodal_hex.cu) read both as they are, so
`prepare_coef` is "contiguous f32" and `apply_prepared` is the same
launch as `apply`.  Both kernels are K1's shared-memory tile kernel
(csrc/hex_tile.cuh) on the node-major layout, with the brick's
reflection-block element product.  For CPU tensors the wrappers run the
plain version, `ops/hex_operator.py::apply_hex_operator`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from topopt_in_petsc_tpu_torch.ops.cuda_build import (
    CudaKernel,
    check_cuda_tensor,
    launch_grid,
)
from topopt_in_petsc_tpu_torch.ops.hex_operator import apply_hex_operator

HELMHOLTZ = CudaKernel("helmholtz_f32")  # K3
NODAL_HEX = CudaKernel("nodal_hex_f32")  # K4


def _nodal_operator(kernel: CudaKernel, dof: int, u: torch.Tensor,
                    eb: torch.Tensor, KE: np.ndarray) -> torch.Tensor:
    """``K(E) u`` with free boundaries; KE is the (8 dof, 8 dof) element
    matrix of this grid level, passed to the kernel as f32."""
    KE = np.ascontiguousarray(KE, dtype=np.float32)
    if KE.shape != (8 * dof, 8 * dof):
        raise ValueError(
            f"element matrix: expected shape {(8 * dof, 8 * dof)}, "
            f"got {KE.shape}"
        )
    if u.device.type == "cpu":
        return apply_hex_operator(u, eb, torch.from_numpy(KE))
    nx, ny, nz = u.shape[:3]
    check_cuda_tensor(u, "u", (nx, ny, nz, dof), torch.float32)
    check_cuda_tensor(eb, "E", (nx - 1, ny - 1, nz - 1), torch.float32)
    if dof * nx * ny * nz >= 2**31:
        raise ValueError(f"grid {(nx, ny, nz)} exceeds 32-bit indexing")
    out = torch.empty_like(u)
    kernel(u.data_ptr(), eb.data_ptr(), out.data_ptr(), KE.ctypes.data,
           nx, ny, nz)
    return out


def helmholtz(u: torch.Tensor, eb: torch.Tensor,
              KF: np.ndarray) -> torch.Tensor:
    """K3: u (nx, ny, nz, 1) f32, eb (nx-1, ny-1, nz-1) f32, KF the
    (8, 8) f32 Helmholtz element matrix."""
    return _nodal_operator(HELMHOLTZ, 1, u, eb, KF)


def nodal_hex(u: torch.Tensor, eb: torch.Tensor,
              KE: np.ndarray) -> torch.Tensor:
    """K4: u (nx, ny, nz, 3) f32, eb (nx-1, ny-1, nz-1) f32, KE the
    (24, 24) f32 elasticity element matrix.  A bf16 u (a level of the
    reduced-precision V-cycle) is widened to f32 for the kernel and the
    result rounded back to bf16, as the JAX package's wrapper casts around
    its Pallas kernel; the coefficient stays f32."""
    if u.dtype == torch.bfloat16:
        return _nodal_operator(NODAL_HEX, 3, u.float(), eb, KE).to(u.dtype)
    return _nodal_operator(NODAL_HEX, 3, u, eb, KE)


def helmholtz_grid(nn) -> Tuple[int, int, int]:
    """The CUDA launch grid of K3 on an `nn` node grid."""
    return launch_grid("helmholtz_grid", nn)


def nodal_hex_grid(nn) -> Tuple[int, int, int]:
    """The CUDA launch grid of K4 on an `nn` node grid."""
    return launch_grid("nodal_hex_grid", nn)


class NodalHexApply:
    """The operator of one grid level, `apply(u, E)` as the JAX package's
    factories return it: its grid size, its element matrix (each MG level
    has its own rediscretized one) and its kernel."""

    def __init__(self, nn: Tuple[int, int, int], KE: np.ndarray, kernel):
        self.nn = tuple(nn)
        # f32 and C-contiguous once, not at every launch
        self.KE = np.ascontiguousarray(KE, dtype=np.float32)
        self._kernel = kernel

    def prepare_coef(self, E: torch.Tensor) -> torch.Tensor:
        """Element coefficient in the kernel's layout: contiguous f32."""
        return E.to(torch.float32).contiguous()

    def apply_prepared(self, u: torch.Tensor,
                       eb: torch.Tensor) -> torch.Tensor:
        if tuple(u.shape[:3]) != self.nn:
            raise ValueError(f"u: grid {tuple(u.shape[:3])}, expected "
                             f"{self.nn}")
        return self._kernel(u, eb, self.KE)

    def __call__(self, u: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
        return self.apply_prepared(u, self.prepare_coef(E))


def make_helmholtz_apply(nn, KF: np.ndarray) -> NodalHexApply:
    """K3 for one grid: u (nx, ny, nz, 1), KF (8, 8)."""
    return NodalHexApply(nn, KF, helmholtz)


def make_nodal_hex_apply(nn, KE: np.ndarray) -> NodalHexApply:
    """K4 for one grid: u (nx, ny, nz, 3), KE (24, 24)."""
    return NodalHexApply(nn, KE, nodal_hex)
