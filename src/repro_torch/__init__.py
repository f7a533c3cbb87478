"""ADSALA on PyTorch and CUDA for the NVIDIA H100: the port of the ``repro``
package (JAX and Pallas on a TPU), module for module.  It imports neither
JAX nor anything of ``repro``; the tests hold it against ``repro``."""

__version__ = "0.1.0"
