"""Port vs JAX package: element matrices, grid hierarchy, the parsed
configuration and its banner (numpy/plain Python, exact or to 1e-12)."""

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.grid import Grid as JaxGrid
from topopt_in_petsc_tpu.models import elements as jel
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.grid import CORNER_OFFSETS, Grid
from topopt_in_petsc_tpu_torch.models import elements as tel

torch.set_num_threads(1)

H = [(0.03125, 0.03125, 0.03125), (0.25, 0.125, 0.5), (1.0, 1.0, 1.0)]


@pytest.mark.parametrize("h", H)
def test_hex8_stiffness_matches(h):
    np.testing.assert_allclose(
        tel.hex8_stiffness(*h, 0.3), jel.hex8_stiffness(*h, 0.3),
        rtol=0, atol=1e-12,
    )


@pytest.mark.parametrize("dof", [1, 3])
def test_octant_matrices_match(dof):
    np.testing.assert_allclose(
        tel.octant_transfer_matrices(dof), jel.octant_transfer_matrices(dof),
        rtol=0, atol=1e-12,
    )
    KE = jel.hex8_stiffness(0.5, 0.25, 0.25, 0.3) if dof == 3 else \
        jel.hex8_laplace_mass(0.5, 0.25, 0.25)[0]
    np.testing.assert_allclose(
        tel.galerkin_octant_matrices(KE, dof),
        jel.galerkin_octant_matrices(KE, dof), rtol=0, atol=1e-12,
    )


def test_helmholtz_matrices_match():
    for a, b in zip(tel.helmholtz_element_matrices(0.1, 0.2, 0.3, 0.04),
                    jel.helmholtz_element_matrices(0.1, 0.2, 0.3, 0.04)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_grid_hierarchy_matches():
    g = Grid(nn=(65, 33, 33))
    j = JaxGrid(nn=(65, 33, 33))
    assert [x.nn for x in g.hierarchy(4)] == [x.nn for x in j.hierarchy(4)]
    assert [x.h for x in g.hierarchy(4)] == [x.h for x in j.hierarchy(4)]
    from topopt_in_petsc_tpu.grid import CORNER_OFFSETS as JCO

    assert CORNER_OFFSETS == JCO


ARGVS = [
    [],
    ["-nx", "17", "-ny", "9", "-nz", "9", "-nlvls", "2", "-rmin", "0.16",
     "-maxItr", "3"],
    ["-filter", "0", "-projectionFilter", "1", "-beta", "1",
     "-betaFinal", "8", "-eta", "0.5", "-volfrac", "0.2"],
    ["-nx", "257", "-ny", "257", "-nz", "257", "-nlvls", "5",
     "-output_cadence_vtu", "0", "-restart", "0", "-ksp_rtol", "1e-6",
     "-cheby_lower", "0.1", "-smooth_sweeps", "3", "-precise_dots", "0"],
    ["-filter", "2", "-pde_nlvls", "4", "-pde_rtol", "1e-7",
     "-pde_maxit", "40"],
    ["-operator_impl", "pallas", "-nlvls", "3"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parsed_config_and_banner_match(argv):
    t = TopOptConfig.from_args(argv)
    j = JaxConfig.from_args(argv)
    jf = {f: getattr(j, f) for f in j.__dataclass_fields__}
    tf = {f: getattr(t, f) for f in t.__dataclass_fields__}
    assert tf.pop("device") == "cuda"
    assert tf == jf
    assert t.banner() == j.banner()
    assert t.resolve_cheby_lower(t.ndof) == j.resolve_cheby_lower(t.ndof)


@pytest.mark.parametrize("argv,item", [
    (["-coarse_op", "galerkin_octant"], 14),
    (["-operator_impl", "xla"], 14),
    (["-ksp_type", "fgmres"], 14),
    (["-dtype", "float64"], 14),
    (["-mesh_shape", "2,2,2"], 15),
    (["-profile_dir", "prof"], 16),
    (["-output_dat", "1"], 17),
])
def test_flags_outside_the_port_raise(argv, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        TopOptConfig.from_args(argv)


@pytest.mark.parametrize("argv,field,value", [
    (["-fused", "1"], "fused", True),
    (["-ksp_chunk", "8"], "ksp_chunk", 8),
    (["-park_design", "1"], "park_design", 1),
    (["-tail_split", "1"], "tail_split", True),
])
def test_fused_and_tpu_lever_flags_are_accepted(argv, field, value):
    """-fused 1 selects the fused driver; the JAX package's TPU levers
    (host-chunked Krylov, design parking, two-program tail) parse and
    change nothing the port computes."""
    cfg = TopOptConfig.from_args(argv)
    assert getattr(cfg, field) == value
    assert cfg.resolve_ksp_chunk(cfg.ndof) == 0
    assert not cfg.resolve_park(cfg.ndof)


def test_device_flag():
    assert TopOptConfig.from_args(["-device", "cpu"]).device == "cpu"
    with pytest.raises(ValueError):
        TopOptConfig.from_args(["-device", "tpu"])


def test_pde_levels_must_halve_the_grid():
    # 64x32x32 elements: 6 PDE levels need 2^5 to divide each count
    TopOptConfig.from_args(["-filter", "2", "-pde_nlvls", "6"])
    with pytest.raises(ValueError, match="PDE filter"):
        TopOptConfig.from_args(["-filter", "2", "-pde_nlvls", "7"])
    # checked only where the PDE filter runs
    TopOptConfig.from_args(["-filter", "1", "-pde_nlvls", "7"])
