"""The port's BLAS L3 kernels: hand-written CUDA for Hopper (``csrc/``),
their plain PyTorch versions, and the tuned dispatch (``ops``)."""

from . import ops, ref

__all__ = ["ops", "ref"]
