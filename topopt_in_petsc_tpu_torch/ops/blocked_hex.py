"""The resident operator: solver vectors live in kernel K1's layout for the
whole solve.

Layout: a vector is a contiguous ``(3, nx, ny, nz)`` tensor (component
major, z fastest) and the element coefficient a contiguous
``(nx-1, ny-1, nz-1)`` tensor, both in the operator's storage dtype: f32,
or bf16 on the levels of a reduced-precision V-cycle.  Every solver
operation (axpys, Jacobi scaling, Chebyshev recurrences, dots, MG
transfers) works on that layout;
the nodal ``(nx, ny, nz, 3)`` form appears only at solve entry and exit.
No position of the layout is padding, so every position is owned and the
ownership-weighted reductions of the JAX package reduce to plain sums.

Boundary conditions are index predicates, never stored fields: the
cantilever's clamped wall is the x == 0 node plane (`mask0`,
LinearElasticity.cc:143-156), the line load is the edge (x = nx-1, z = 0)
(`cantilever_rhs`, LinearElasticity.cc:158-171).

Kernel K1 (csrc/hex_operator.cu) computes the free-BC operator, optionally
with the x == 0 plane masked in the same pass (`apply`), in two builds:
f32 storage, and bf16 storage with every operation in f32 (the JAX
package's `BlockedHexOperator(dtype=jnp.bfloat16)`).  For CPU tensors the
wrapper runs the plain version, `apply_hex_operator` then `mask0` on the
inputs widened to f32, the result rounded to the storage dtype.
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

HEX_OPERATOR = CudaKernel("hex_operator_f32")
HEX_OPERATOR_BF16 = CudaKernel("hex_operator_bf16")
# the kernel of each storage dtype
_BUILDS = {torch.float32: HEX_OPERATOR, torch.bfloat16: HEX_OPERATOR_BF16}


def mask0(vb: torch.Tensor) -> torch.Tensor:
    """Zero the x == 0 node plane (cantilever clamped wall)."""
    out = vb.clone()
    out[:, 0] = 0.0
    return out


def hex_operator(
    vb: torch.Tensor, eb: torch.Tensor, KE: np.ndarray, mask_x0: bool
) -> torch.Tensor:
    """K1: ``K(E) v`` on the resident layout, with the x == 0 plane zeroed
    when `mask_x0`.  vb: (3, nx, ny, nz), eb: (nx-1, ny-1, nz-1), both f32
    or both bf16 (the bf16-storage build: every operation in f32, the
    result rounded to bf16 once); KE: the (24, 24) element matrix of this
    grid level, f32 in either build."""
    if vb.dtype not in _BUILDS:
        raise ValueError(f"v: expected f32 or bf16, got {vb.dtype}")
    if vb.device.type == "cpu":
        KEt = torch.as_tensor(np.asarray(KE), dtype=torch.float32)
        out = apply_hex_operator(vb.permute(1, 2, 3, 0).float(), eb.float(),
                                 KEt)
        out = out.permute(3, 0, 1, 2).contiguous()
        return (mask0(out) if mask_x0 else out).to(vb.dtype)
    _, nx, ny, nz = vb.shape
    check_cuda_tensor(vb, "v", (3, nx, ny, nz), vb.dtype)
    check_cuda_tensor(eb, "E", (nx - 1, ny - 1, nz - 1), vb.dtype)
    if 3 * nx * ny * nz >= 2**31:
        raise ValueError(f"grid {(nx, ny, nz)} exceeds 32-bit indexing")
    ke = np.ascontiguousarray(KE, dtype=np.float32)
    if ke.shape != (24, 24):
        raise ValueError(f"KE: expected shape (24, 24), got {ke.shape}")
    out = torch.empty_like(vb)
    _BUILDS[vb.dtype](
        vb.data_ptr(), eb.data_ptr(), out.data_ptr(), ke.ctypes.data,
        nx, ny, nz, int(mask_x0),
    )
    return out


def hex_operator_grid(nn, dtype=torch.float32) -> Tuple[int, int, int]:
    """The CUDA launch grid of `hex_operator` on an `nn` node grid for
    storage `dtype`: a profiler's record of K1 tells the multigrid levels
    apart by it."""
    query = {torch.float32: "hex_operator_grid",
             torch.bfloat16: "hex_operator_bf16_grid"}[dtype]
    return launch_grid(query, nn)


class BlockedHexOperator:
    """Resident-layout matrix-free K(x) for one grid level, with vectors and
    coefficient stored in `dtype` (f32 or bf16; K1 computes in f32)."""

    def __init__(self, nn: Tuple[int, int, int], KE: np.ndarray, *,
                 device: torch.device, dtype=torch.float32):
        if dtype not in _BUILDS:
            raise ValueError(f"storage dtype must be f32 or bf16: {dtype}")
        self.nn = tuple(nn)
        self.dof = 3
        self.device = torch.device(device)
        self.dtype = dtype
        # KE goes to the kernel by value, as f32
        self.KE = np.ascontiguousarray(KE, dtype=np.float32)

    # -- layout conversion (solve entry/exit only) ---------------------- #

    def to_blocked(self, u: torch.Tensor) -> torch.Tensor:
        """(nx, ny, nz, 3) -> (3, nx, ny, nz) in the storage dtype."""
        return u.to(self.dtype).permute(3, 0, 1, 2).contiguous()

    def from_blocked(self, vb: torch.Tensor, dtype=None) -> torch.Tensor:
        """(3, nx, ny, nz) -> (nx, ny, nz, 3)."""
        out = vb.permute(1, 2, 3, 0).contiguous()
        return out if dtype is None else out.to(dtype)

    def prepare_coef(self, E: torch.Tensor) -> torch.Tensor:
        """Element coefficient in the kernel's layout: contiguous, in the
        storage dtype."""
        return E.to(self.dtype).contiguous()

    # -- resident-layout operations ------------------------------------- #

    def matvec(self, vb: torch.Tensor, eb: torch.Tensor) -> torch.Tensor:
        """Free-BC ``K @ v``."""
        return hex_operator(vb, eb, self.KE, mask_x0=False)

    def apply(self, vb: torch.Tensor, eb: torch.Tensor) -> torch.Tensor:
        """``mask0(K @ v)`` in one pass: the solver's operator."""
        return hex_operator(vb, eb, self.KE, mask_x0=True)

    mask0 = staticmethod(mask0)

    def cantilever_rhs(self, load: float = -0.001,
                       dtype=torch.float32) -> torch.Tensor:
        """Resident RHS of the reference line load: F_z = load along the
        edge (x = nx-1, z = 0), halved at the two y corners
        (LinearElasticity.cc:158-171)."""
        nx, ny, nz = self.nn
        y = torch.arange(ny, device=self.device)
        w = torch.where((y == 0) | (y == ny - 1), 0.5, 1.0).to(dtype)
        b = torch.zeros((3, nx, ny, nz), dtype=dtype, device=self.device)
        b[2, nx - 1, :, 0] = torch.tensor(load, dtype=dtype) * w
        return b

    def dot(self, a: torch.Tensor, b: torch.Tensor,
            precise: bool = True) -> torch.Tensor:
        """Inner product; f32 products summed in f64 when `precise`."""
        if precise:
            return torch.sum(a * b, dtype=torch.float64)
        return torch.sum(a * b)

    def asum(self, a: torch.Tensor, precise: bool = True) -> torch.Tensor:
        if precise:
            return torch.sum(a, dtype=torch.float64)
        return torch.sum(a)
