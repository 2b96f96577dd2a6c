"""Device milliseconds per iteration of MMA: the records that
`fused.mma_start` (movelimits, the subproblem, the dual's carry),
`fused.dip` (the dual interior point's segments) and `fused.post_x`
(x(lambda) and ch, under `-filter 2` only) own (`perfbench/spans.py`)."""

from perfbench import spans


def read(w):
    return spans.ms_per_iter(w, spans.MMA)
