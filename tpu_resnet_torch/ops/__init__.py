"""Kernels of the port: CUDA sources in ``csrc/``, wrappers here."""
