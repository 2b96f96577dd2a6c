"""Hex operators, the hand-written kernels K1 and K2, and the filter convolutions."""
