"""The Helmholtz PDE filter (`-filter 2`) with Heaviside projection on an
asymmetric mesh, (4,2,1), port against the JAX package: 33x17x9 nodes,
2 MG levels, `-projectionFilter 1 -beta 1`, 3 iterations in float64 (the
`xla` route of both), against `docs/jax_cpu_spmd_33x17x9_mesh421_filter2_
float64.npz`, the JAX CLI's `-mesh_shape 4,2,1` history with these flags
(about 45 s to run on the CPU; its command in PERF.md).

Bars: fx rtol 1e-6, gx and mnd atol 1e-8, ch atol 1e-7, the same solver
iterations.  The filter's solves stop at `-pde_rtol 1e-8`, so the two
packages' filtered fields differ at about that level and fx by up to
1.6e-7 (measured), where the `-filter 1` history agrees to 6e-9
(tests/test_torch_spmd_cli.py).  The bound-violation warning of iteration
3 is printed by rank 0, once.
"""

import os

import numpy as np
import torch

from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import run_topopt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pde_filter_projection_on_421_matches_jax(tmp_path, capfd):
    cfg = TopOptConfig.from_args([
        "-device", "cpu", "-nx", "33", "-ny", "17", "-nz", "9", "-nlvls",
        "2", "-rmin", "0.16", "-filter", "2", "-projectionFilter", "1",
        "-beta", "1", "-maxItr", "3", "-mesh_shape", "4,2,1", "-dtype",
        "float64", "-output_cadence_vtu", "0", "-workdir", str(tmp_path)])
    h = run_topopt(cfg)
    out = capfd.readouterr().out
    with np.load(os.path.join(
            REPO, "docs",
            "jax_cpu_spmd_33x17x9_mesh421_filter2_float64.npz")) as r:
        ref = {k: r[k] for k in r.files}
    np.testing.assert_allclose(h["fx"], ref["fx"], rtol=1e-6)
    np.testing.assert_allclose(h["gx"], ref["gx"], atol=1e-8)
    np.testing.assert_allclose(h["mnd"], ref["mnd"], atol=1e-8)
    np.testing.assert_allclose(h["ch"], ref["ch"], atol=1e-7)
    np.testing.assert_array_equal(h["iters"], ref["iters"])
    assert out.count("BOUND VIOLATION IN PDEFILTER") == 1
