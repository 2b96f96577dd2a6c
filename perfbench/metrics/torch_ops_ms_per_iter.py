"""Device milliseconds per iteration of every kernel other than the
hand-written operator kernels K1-K4: the vector arithmetic, reductions,
FFTs and library kernels that plain PyTorch launches."""

from perfbench.readers import KERNEL_NAMES, per_iter


def read(w):
    us = sum(float(e["dur"]) for e in w.kernels()
             if not any(n in e["name"] for n in KERNEL_NAMES.values()))
    return per_iter(us * 1e-3, w)
