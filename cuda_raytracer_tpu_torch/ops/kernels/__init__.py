"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``)."""
