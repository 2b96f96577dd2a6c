"""Kernel K3's share of its roofline over the window's runs, in %: the
compulsory-bytes bound of each run at its level's grid, summed, over the
runs' summed device time."""

from perfbench.readers import roofline_pct


def read(w):
    return roofline_pct(w, "K3")
