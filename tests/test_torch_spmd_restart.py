"""Restart and output of `-mesh_shape`: a run of 2 iterations on mesh
(2,2,2) writes its restart files, `.dat` and VTU from rank 0; the restart
resumes on one device (the split `Driver` and the `-fused 1` driver) and
on mesh (2,1,1) for iterations 3 and 4, which match the uninterrupted
4-iteration run on (2,2,2).  17x9x9 nodes, 2 MG levels, float64; the
restart files hold global arrays, so any mesh shape reads them.

Across the two packages: the JAX split driver (`-dtype float64`, its
`xla` route on the CPU) resumes the mesh's restart for iteration 3, which
matches the mesh's uninterrupted iteration 3; and the port's mesh (2,1,1)
resumes a restart that the JAX split driver wrote after 2 iterations, its
iteration 3 matching the JAX driver's uninterrupted one.  Each resume
continues the run that wrote it (to about 2e-14); the two packages' own
histories differ by about 6e-10 in fx and 3e-10 in ch at iteration 3.

Bars: fx rtol 1e-9, gx and ch atol 1e-10, the same solver iterations
(the resumed runs agree to about 3e-14: only the sums' order differs).
The `.dat` and the restart file hold the gathered fields: the `.dat`'s
last step is the final design, the design of the restart file.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu.driver import run_topopt as jax_run_topopt
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import run_topopt
from topopt_in_petsc_tpu_torch.io.mpiio_dat import read_dat

torch.set_num_threads(1)

GRID = ["-nx", "17", "-ny", "9", "-nz", "9", "-nlvls", "2", "-rmin", "0.16",
        "-dtype", "float64"]
FLAGS = ["-device", "cpu", *GRID]


def _run(workdir, *flags):
    cfg = TopOptConfig.from_args([*FLAGS, *flags, "-workdir", str(workdir)])
    return run_topopt(cfg)


def _jax(workdir, *flags):
    """The JAX package's split driver with the grid's flags (its log
    dropped)."""
    cfg = JaxConfig.from_args([*GRID, "-output_cadence_vtu", "0", *flags,
                               "-workdir", str(workdir)])
    with contextlib.redirect_stdout(io.StringIO()):
        return jax_run_topopt(cfg)


def _resume_flags(workdir):
    return ["-restartFileVec", str(workdir / "Restart00.npz"),
            "-restartFileVecSol", str(workdir / "RestartSol00.npz")]


def _assert_continues(h, ref, its):
    """h continues ref at iterations `its` (slice of ref) by the f64
    bars."""
    np.testing.assert_allclose(h["fx"], ref["fx"][its], rtol=1e-9)
    np.testing.assert_allclose(h["gx"], ref["gx"][its], atol=1e-10)
    np.testing.assert_allclose(h["ch"], ref["ch"][its], atol=1e-10)
    np.testing.assert_array_equal(h["iters"], ref["iters"][its])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_restart")
    whole = _run(tmp / "whole", "-maxItr", "4", "-mesh_shape", "2,2,2",
                 "-output_cadence_vtu", "0", "-restart", "0")
    first = _run(tmp / "first", "-maxItr", "2", "-mesh_shape", "2,2,2",
                 "-output_dat", "1")
    return tmp, whole, first


def test_outputs_written_from_rank_zero(runs):
    tmp, _, first = runs
    files = set(os.listdir(tmp / "first"))
    # iterations 1-2 and the final dump (iteration 3), one restart pair
    for name in ("output_00001.vtu", "output_00002.vtu", "output_00003.vtu",
                 "output_00000.dat", "Restart00.npz", "RestartSol00.npz"):
        assert name in files
    dat = read_dat(str(tmp / "first" / "output_00000.dat"))
    assert [s["itr"] for s in dat["steps"]] == [1, 2, 3]
    with np.load(tmp / "first" / "Restart00.npz") as r:
        assert int(r["itr"]) == 2
        x = r["x"]
        assert x.shape == (16, 8, 8)
    np.testing.assert_array_equal(dat["steps"][-1]["cell_fields"]["x"],
                                  x.astype(np.float32).ravel())
    with np.load(tmp / "first" / "RestartSol00.npz") as r:
        assert r["u"].shape == (17, 9, 9, 3) and np.isfinite(r["u"]).all()


@pytest.mark.parametrize("flags", [
    pytest.param(["-mesh_shape", "1,1,1"], id="1,1,1"),
    pytest.param(["-mesh_shape", "2,1,1"], id="2,1,1"),
    pytest.param(["-fused", "1"], id="fused")])
def test_restart_resumes_on_another_mesh(runs, flags):
    tmp, whole, _ = runs
    h = _run(tmp / f"resume_{'_'.join(flags)}", "-maxItr", "4", *flags,
             "-output_cadence_vtu", "0", *_resume_flags(tmp / "first"))
    assert len(h["fx"]) == 2
    _assert_continues(h, whole, slice(2, None))


def test_jax_resumes_the_mesh_restart(runs):
    tmp, whole, _ = runs
    h = _jax(tmp / "jax_resume", "-maxItr", "3",
             *_resume_flags(tmp / "first"))
    assert len(h["fx"]) == 1
    _assert_continues(h, whole, slice(2, 3))


def test_mesh_resumes_a_jax_restart(tmp_path):
    ref = _jax(tmp_path / "jax3", "-maxItr", "3", "-restart", "0")
    _jax(tmp_path / "jax2", "-maxItr", "2")
    h = _run(tmp_path / "mesh", "-maxItr", "3", "-mesh_shape", "2,1,1",
             "-output_cadence_vtu", "0", *_resume_flags(tmp_path / "jax2"))
    assert len(h["fx"]) == 1
    _assert_continues(h, ref, slice(2, 3))
