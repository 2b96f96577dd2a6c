"""Device milliseconds per iteration of the objective and the filter: the
records that `fused.head` (K2, the sensitivities, the filter's chain
rule), `fused.pde_start`, `fused.pde` and `fused.pde_finish` (the PDE
filter's solves) and `fused.post` (the design filter and the state
write) own (`perfbench/spans.py`).  Under `-filter 1` the design update
x(lambda) has no stage of its own and runs in `fused.post`, so it is
counted here and not in `mma_ms_per_iter`."""

from perfbench import spans


def read(w):
    return spans.ms_per_iter(w, spans.FILTER)
