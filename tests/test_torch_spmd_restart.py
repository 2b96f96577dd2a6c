"""Restart and output of `-mesh_shape`: a run of 2 iterations on mesh
(2,2,2) writes its restart files, `.dat` and VTU from rank 0; the restart
resumes on one device (the split `Driver`) and on mesh (2,1,1) for
iterations 3 and 4, which match the uninterrupted 4-iteration run on
(2,2,2).  17x9x9 nodes, 2 MG levels, float64; the restart files hold
global arrays, so any mesh shape reads them.

Bars: fx rtol 1e-9, gx and ch atol 1e-10, the same solver iterations
(the resumed runs agree to about 3e-14: only the sums' order differs).
The `.dat` and the restart file hold the gathered fields: the `.dat`'s
last step is the final design, the design of the restart file.
"""

import os

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import run_topopt
from topopt_in_petsc_tpu_torch.io.mpiio_dat import read_dat

torch.set_num_threads(1)

FLAGS = ["-device", "cpu", "-nx", "17", "-ny", "9", "-nz", "9", "-nlvls",
         "2", "-rmin", "0.16", "-dtype", "float64"]


def _run(workdir, *flags):
    cfg = TopOptConfig.from_args([*FLAGS, *flags, "-workdir", str(workdir)])
    return run_topopt(cfg)


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


@pytest.mark.parametrize("mesh", ["1,1,1", "2,1,1"])
def test_restart_resumes_on_another_mesh(runs, mesh):
    tmp, whole, _ = runs
    h = _run(tmp / f"resume_{mesh}", "-maxItr", "4", "-mesh_shape", mesh,
             "-output_cadence_vtu", "0",
             "-restartFileVec", str(tmp / "first" / "Restart00.npz"),
             "-restartFileVecSol", str(tmp / "first" / "RestartSol00.npz"))
    np.testing.assert_allclose(h["fx"], whole["fx"][2:], rtol=1e-9)
    np.testing.assert_allclose(h["gx"], whole["gx"][2:], atol=1e-10)
    np.testing.assert_allclose(h["ch"], whole["ch"][2:], atol=1e-10)
    np.testing.assert_array_equal(h["iters"], whole["iters"][2:])
