"""Kernels K1-K4 on the local blocks of `-mesh_shape`, on the card,
against their plain PyTorch versions.  Marked `cuda`; skipped where no
CUDA device is visible.  Run on a GPU machine with
    python -m pytest --noconftest tests/test_torch_spmd_kernels_cuda.py

The blocks are those the mesh runs give the kernels, which the single-card
runs never do: 129x257x257 nodes (257^3 on mesh (2,1,1)) and its level-2
and level-4 blocks 33x65x65 and 9x17x17, 129x33x33, the 17x9x9-class
blocks 9x5x5 and 9x9x9 of the small meshes and the coarse 5x3x3 and
5x5x5, each with the element matrix of its level's global grid.  K1 with
the x = 0 wall masked (a rank at x-coordinate 0) and without (every other
rank).  Bar: rtol 2e-5, atol 1e-5 of max|ref|
(tests/test_torch_kernels_cuda.py's).
"""

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.models.elements import (
    helmholtz_element_matrices,
    hex8_stiffness,
)
from topopt_in_petsc_tpu_torch.ops.blocked_hex import hex_operator, mask0
from topopt_in_petsc_tpu_torch.ops.hex_operator import (
    apply_hex_operator,
    element_quadratic_form,
)
from topopt_in_petsc_tpu_torch.ops.nodal_hex import helmholtz, nodal_hex
from topopt_in_petsc_tpu_torch.ops.quadform import quadform
from topopt_in_petsc_tpu_torch.parallel.decomp import BlockDecomp

pytestmark = pytest.mark.cuda

# (global nodes, mesh, levels, level): the rank's block is
# decomp.local_nn(level)
BLOCKS = [((257, 257, 257), (2, 1, 1), 1, 0),
          ((257, 257, 257), (2, 1, 1), 5, 2),
          ((257, 257, 257), (2, 1, 1), 5, 4),
          ((257, 33, 33), (2, 1, 1), 1, 0),
          ((17, 9, 9), (2, 2, 2), 1, 0),
          ((17, 17, 17), (2, 2, 2), 1, 0),
          ((33, 17, 17), (2, 2, 2), 3, 2),
          ((33, 17, 9), (4, 2, 1), 2, 1)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _block(block, dof, dev, seed):
    """(level grid, u, E) of a rank's block."""
    nn, mesh, nlvls, level = block
    d = BlockDecomp(Grid(nn=nn), mesh, nlvls)
    local = d.local_nn(level)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.normal(size=(*local, dof)), dtype=torch.float32,
                        device=dev)
    E = torch.as_tensor(rng.uniform(1e-9, 1.0, size=[n - 1 for n in local]),
                        dtype=torch.float32, device=dev)
    return d.level_grid(level), u, E


def _plain(u, E, K):
    return apply_hex_operator(u, E, torch.as_tensor(K, dtype=torch.float32,
                                                    device=u.device))


def _close(got, ref):
    scale = float(torch.max(torch.abs(ref)))
    err = torch.abs(got - ref)
    assert bool(torch.all(err <= 2e-5 * torch.abs(ref) + 1e-5 * scale)), \
        float(torch.max(err))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("wall", [True, False])
def test_k1_on_a_block_matches_plain(dev, block, wall):
    grid, u, E = _block(block, 3, dev, seed=11)
    KE = hex8_stiffness(*grid.h, 0.3)
    vb = u.permute(3, 0, 1, 2).contiguous()
    got = hex_operator(vb, E, KE, mask_x0=wall)
    ref = _plain(u, E, KE).permute(3, 0, 1, 2).contiguous()
    _close(got, mask0(ref) if wall else ref)


@pytest.mark.parametrize("block", BLOCKS)
def test_k2_on_a_block_matches_plain(dev, block):
    grid, u, _ = _block(block, 3, dev, seed=13)
    KE = hex8_stiffness(*grid.h, 0.3)
    ref = element_quadratic_form(u, torch.as_tensor(
        KE, dtype=torch.float32, device=dev))
    _close(quadform(u, KE), ref)


@pytest.mark.parametrize("block", BLOCKS)
def test_k3_on_a_block_matches_plain(dev, block):
    grid, u, E = _block(block, 1, dev, seed=14)
    KF = helmholtz_element_matrices(*grid.h, 0.16 / (2 * 3**0.5))[0]
    KF = np.ascontiguousarray(KF, dtype=np.float32)
    _close(helmholtz(u, E, KF), _plain(u, E, KF))


@pytest.mark.parametrize("block", BLOCKS)
def test_k4_on_a_block_matches_plain(dev, block):
    grid, u, E = _block(block, 3, dev, seed=12)
    KE = hex8_stiffness(*grid.h, 0.3)
    _close(nodal_hex(u, E, KE), _plain(u, E, KE))
