"""The benchmark's CPU tests: `python -m pytest perfbench/tests` from the
repository's root.  Tests marked `cuda` need a card and skip without
one; on a card: `python -m pytest -m cuda perfbench/tests`."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small(spec: dict, size=(17, 9, 9), **flags) -> dict:
    """The cell's spec at a size a CPU test holds: 2 multigrid levels, a
    filter radius that spans a neighbour."""
    nx, ny, nz = size
    spec["flags"].update(nx=nx, ny=ny, nz=nz, nlvls=2, rmin=0.16,
                         pde_nlvls=2, **flags)
    return spec
