"""Pluggable execution layer (paper: MKL-vs-BLIS generality).

The :class:`Backend` protocol abstracts one BLAS L3 implementation; the
module-level registry holds the process's backends.  The built-ins are
registered on import:

  hopper — hand-written CUDA kernels for the H100 (on the CUDA card)
  ref    — PyTorch oracles, reachable by name only
"""

from .base import Backend, L3_OPS
from .hopper import HopperBackend
from .ref import RefBackend
from .registry import (available_backends, get_backend, register_backend,
                       resolve_backend, unregister_backend)

__all__ = [
    "Backend", "L3_OPS", "HopperBackend", "RefBackend",
    "register_backend", "unregister_backend", "get_backend",
    "available_backends", "resolve_backend",
]


def _install_builtins() -> None:
    for cls in (HopperBackend, RefBackend):
        be = cls()
        if be.name not in available_backends():
            register_backend(be)


_install_builtins()
