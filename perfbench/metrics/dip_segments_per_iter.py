"""Segments of MMA's dual interior point per iteration: the `fused.dip`
spans.  Each segment runs 8 predicated Newton trips, useful or not, so
this counts the dual's device work."""

from perfbench import spans


def read(w):
    return spans.count_per_iter(w, "fused.dip")
