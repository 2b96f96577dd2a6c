"""topopt_in_petsc_tpu_torch — the PyTorch/CUDA port of topopt_in_petsc_tpu.

Minimum-compliance SIMP topology optimization on structured hex grids
(the capabilities of the PETSc/MPI reference `topopt/TopOpt_in_PETSc`),
on one NVIDIA GPU:

- the matrix-free elasticity operator (resident and nodal layouts), the
  Helmholtz operator of the PDE filter and the element quadratic form
  are hand-written CUDA kernels (csrc/), with plain PyTorch versions
  beside them that run for CPU tensors;
- the state solve is multigrid-preconditioned flexible CG with every
  vector resident in the operator kernel's layout, or, under
  `-operator_impl pallas`, on the nodal field with stored masks;
- density/sensitivity/PDE filters, Heaviside projection, MMA in f64,
  restart files and VTU output follow the JAX package
  `topopt_in_petsc_tpu`, which stays the reference and is never
  imported here.

Importing the package turns TF32 off for cuDNN convolutions and CUDA
matmuls, so the density filter's direct convolution runs in full f32.
"""

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

from topopt_in_petsc_tpu_torch.config import TopOptConfig  # noqa: E402
from topopt_in_petsc_tpu_torch.grid import Grid  # noqa: E402

__version__ = "0.1.0"

__all__ = ["TopOptConfig", "Grid", "__version__"]
