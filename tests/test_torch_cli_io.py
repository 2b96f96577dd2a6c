"""The port's CLI and IO: no jax import, the `-device cuda` refusal on a
machine without CUDA, `history.npz`, restart checksums and state, and
VTU bytes against the JAX package's writer."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from topopt_in_petsc_tpu.grid import Grid as JaxGrid
from topopt_in_petsc_tpu.io import native
from topopt_in_petsc_tpu.io.vtu import write_state_vtu as jax_write_vtu
from topopt_in_petsc_tpu_torch.__main__ import main
from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.io.restart import (
    RestartManager,
    checksum64,
    state_from_numpy,
)
from topopt_in_petsc_tpu_torch.io.vtu import write_state_vtu

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "topopt_in_petsc_tpu_torch", "topopt_in_petsc_tpu_torch.__main__",
    "topopt_in_petsc_tpu_torch.driver",
    "topopt_in_petsc_tpu_torch.ops.blocked_hex",
    "topopt_in_petsc_tpu_torch.ops.quadform",
    "topopt_in_petsc_tpu_torch.ops.cuda_build",
    "topopt_in_petsc_tpu_torch.solvers.blocked_mg",
    "topopt_in_petsc_tpu_torch.io.restart",
]


def _python(code, **env):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300, env={**os.environ, **env},
    )


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'topopt_in_petsc_tpu'"
        " or m.startswith('topopt_in_petsc_tpu.')]\n"
        "print(bad)\n"
        "import torch\n"
        "print(torch.backends.cudnn.allow_tf32,"
        " torch.backends.cuda.matmul.allow_tf32)\n"
    )
    p = _python(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split("\n")[:2] == ["[]", "False False"]


def test_device_cuda_without_gpu_raises(tmp_path):
    code = (
        "from topopt_in_petsc_tpu_torch.__main__ import main\n"
        f"main(['-nx', '9', '-ny', '5', '-nz', '5', '-nlvls', '2',"
        f" '-maxItr', '1', '-workdir', {str(tmp_path)!r}])\n"
    )
    p = _python(code, CUDA_VISIBLE_DEVICES="")
    assert p.returncode != 0
    assert "RuntimeError: -device cuda: no CUDA device" in p.stderr
    assert not (tmp_path / "history.npz").exists()


def test_cli_writes_history(tmp_path, capsys):
    assert main(["-device", "cpu", "-nx", "9", "-ny", "5", "-nz", "5",
                 "-nlvls", "2", "-maxItr", "2", "-workdir",
                 str(tmp_path)]) == 0
    with np.load(tmp_path / "history.npz") as h, \
            np.load(os.path.join(REPO, "docs",
                                 "jax_cpu_history_65x33x33.npz")) as ref:
        assert set(h.files) == set(ref.files)
        assert len(h["fx"]) == 2 and np.isfinite(h["fx"]).all()
    for name in ("output_00001.vtu", "output_00003.vtu", "Restart00.npz",
                 "RestartSol00.npz"):
        assert (tmp_path / name).exists()
    assert "It.: 2, True fx:" in capsys.readouterr().out


@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 20) + 3, 3 << 20])
def test_checksum_matches_native_codec(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert checksum64(data) == native.checksum64(data)


def test_restart_roundtrip_and_state(tmp_path):
    rng = np.random.default_rng(0)
    ne = (4, 2, 2)
    x = rng.uniform(size=ne)
    mgr = RestartManager(str(tmp_path))
    mgr.write(7, 0.5, torch.from_numpy(x), x.astype(np.float32),
              x, x, x + 1, x - 1, np.zeros((5, 3, 3, 3), np.float32))
    d = mgr.load(str(tmp_path / "Restart00.npz"))
    assert d is not None
    d["u"] = mgr.load_state(str(tmp_path / "RestartSol00.npz"))
    st = state_from_numpy(d, torch.device("cpu"))
    assert st["itr"] == 7 and st["fscale"] == 0.5
    assert {st[k].dtype for k in ("xo1", "xo2", "U", "L")} == {torch.float64}
    assert {st[k].dtype for k in ("x", "xPhys", "u")} == {torch.float32}
    np.testing.assert_array_equal(st["U"].numpy(), x + 1)
    # a corrupt file is refused
    with np.load(tmp_path / "Restart00.npz") as z:
        bad = {k: z[k] for k in z.files}
    bad["x"] = bad["x"] + 1.0
    np.savez(tmp_path / "bad.npz", **bad)
    assert mgr.load(str(tmp_path / "bad.npz")) is None


def test_vtu_bytes_match_jax_writer(tmp_path):
    nn = (5, 4, 3)
    rng = np.random.default_rng(2)
    u = rng.normal(size=(*nn, 3)).astype(np.float32)
    xs = [rng.uniform(size=(4, 3, 2)) for _ in range(3)]
    write_state_vtu(str(tmp_path / "p.vtu"), Grid(nn=nn),
                    torch.from_numpy(u), *map(torch.from_numpy, xs))
    jax_write_vtu(str(tmp_path / "j.vtu"), JaxGrid(nn=nn), u, *xs)
    assert (tmp_path / "p.vtu").read_bytes() == \
        (tmp_path / "j.vtu").read_bytes()
