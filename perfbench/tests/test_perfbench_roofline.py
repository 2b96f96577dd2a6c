"""The frozen bytes bound of the operator kernels."""

import pytest

from perfbench import roofline

CARD = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("kernel,ms", [("K1", 0.1416), ("K1-bf16", 0.0708),
                                       ("K3", 0.0606), ("K4", 0.1416)])
def test_bound_at_257(kernel, ms):
    assert round(roofline.bound_s(kernel, (257,) * 3, CARD) * 1e3, 4) == ms


def test_the_bytes_bound_every_kernel():
    for kernel in ("K1", "K1-bf16", "K2", "K3", "K4"):
        for n in (9, 17, 129, 257, 513):
            t_bytes = roofline.work_bytes(kernel, (n,) * 3) / 3.35e12
            t_ops = roofline.work_flop(kernel, (n,) * 3) / 67e12
            assert t_bytes > t_ops, (kernel, n)


def test_unknown_card_raises():
    with pytest.raises(ValueError):
        roofline.bound_s("K1", (17, 9, 9), "some other card")
