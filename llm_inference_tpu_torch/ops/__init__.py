"""Numerics, the serve-mode matmul dispatch, and the hand-written kernels."""
