"""Host launch calls per iteration, of kernels and of CUDA graphs."""

from perfbench.readers import per_iter
from perfbench.tracing import LAUNCH_CALLS


def read(w):
    return per_iter(sum(e["name"] in LAUNCH_CALLS for e in w.host), w)
