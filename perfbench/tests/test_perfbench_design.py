"""The seeded design and its file, against the program's own loader."""

import numpy as np
import pytest
import torch

from perfbench.design import (
    checksum64,
    run_design,
    seeded_design,
    write_design,
)


@pytest.mark.parametrize("ne", [(16, 8, 8), (32, 16, 16), (9, 5, 3)])
def test_same_bits_in_numpy_and_torch(ne):
    seed = 2 ** 31 + 4321
    a = seeded_design(ne, 0.12, seed, 12.5)
    b = seeded_design(ne, 0.12, seed, 12.5, device="cpu")
    assert np.array_equal(a, b)
    assert a.shape == ne and a.min() >= 0.05 and a.max() <= 0.95


def test_the_seed_changes_the_design_and_fixes_it():
    a = seeded_design((16, 8, 8), 0.12, 1, 12.5)
    assert np.array_equal(a, seeded_design((16, 8, 8), 0.12, 1, 12.5))
    assert not np.array_equal(a, seeded_design((16, 8, 8), 0.12, 2, 12.5))


def test_the_program_loads_the_file(tmp_path):
    from topopt_in_petsc_tpu_torch.io.restart import (
        RestartManager,
        checksum64 as program_checksum,
    )

    x = seeded_design((16, 8, 8), 0.12, 7, 12.5)
    assert checksum64(x) == program_checksum(x)
    path = tmp_path / "design.npz"
    write_design(str(path), x)
    data = RestartManager(str(tmp_path)).load(str(path))
    assert data is not None and np.array_equal(data["x"], x)
    assert set(data) == {"x", "checksum"}


def test_checksum_of_a_torch_buffer_is_the_numpy_one():
    x = seeded_design((9, 5, 3), 0.12, 3, 12.5)
    assert checksum64(torch.as_tensor(x).numpy()) == checksum64(x)


def test_a_run_design_is_the_traffics_mirrored_by_the_seeds_parity():
    traffic = {"design_seed": 16, "amplitude": 12.5}
    even = run_design((16, 8, 8), 0.12, 2 ** 31 + 2, traffic)
    odd = run_design((16, 8, 8), 0.12, 2 ** 31 + 1, traffic, device="cpu")
    assert np.array_equal(even, seeded_design((16, 8, 8), 0.12, 16, 12.5))
    assert np.array_equal(odd, even[:, ::-1, :])
    assert odd.flags.c_contiguous
