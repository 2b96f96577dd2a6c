"""Device milliseconds per iteration of the state solve: the records that
the spans `fused.pre` (SIMP, the MG set-up, the Krylov carry),
`fused.pcg` (the loop's segments) and `fused.close` (FGMRES's cycle
close) own (`perfbench/spans.py`)."""

from perfbench import spans


def read(w):
    return spans.ms_per_iter(w, spans.SOLVE)
