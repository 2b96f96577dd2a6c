"""Kernel K2: the per-element quadratic form ``u_e^T KE u_e``.

Counterpart of the JAX package's `ops/pallas_hex.py::make_pallas_quadform`:
the compliance ``fx = sum_e E_e q_e`` and its sensitivity
``dfdx = -p x^(p-1) (Emax - Emin) q`` both come from ``q``
(models/elasticity.py).  For CPU tensors the wrapper runs the plain
version, `ops/hex_operator.py::element_quadratic_form`.
"""

from __future__ import annotations

import numpy as np
import torch

from topopt_in_petsc_tpu_torch.ops.cuda_build import (
    CudaKernel,
    check_cuda_tensor,
)
from topopt_in_petsc_tpu_torch.ops.hex_operator import element_quadratic_form

QUADFORM = CudaKernel("quadform_f32")


def quadform(u: torch.Tensor, KE: np.ndarray) -> torch.Tensor:
    """(nx, ny, nz, 3) f32 nodal field -> (ex, ey, ez) f32 ``u_e^T KE u_e``.
    KE: the (24, 24) element matrix."""
    if u.device.type == "cpu":
        return element_quadratic_form(
            u, torch.as_tensor(np.asarray(KE), dtype=u.dtype)
        )
    nx, ny, nz, _ = u.shape
    check_cuda_tensor(u, "u", (nx, ny, nz, 3), torch.float32)
    if 3 * nx * ny * nz >= 2**31:
        raise ValueError(f"grid {(nx, ny, nz)} exceeds 32-bit indexing")
    ke = np.ascontiguousarray(KE, dtype=np.float32)
    if ke.shape != (24, 24):
        raise ValueError(f"KE: expected shape (24, 24), got {ke.shape}")
    q = torch.empty(
        (nx - 1, ny - 1, nz - 1), dtype=torch.float32, device=u.device
    )
    QUADFORM(u.data_ptr(), q.data_ptr(), ke.ctypes.data, nx, ny, nz)
    return q
