"""Tensor ops of the port; kernels live in ``csrc/``."""
