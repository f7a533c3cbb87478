"""Process-global backend registry.

``resolve_backend(name)`` is the dispatch policy of
:func:`repro_torch.kernels.ops.run_op`: the requested backend, on its own
device or the one the caller names, or an error.  Unlike the reference
package's registry there is no fallback chain: a request for the ``hopper``
backend on a host with no card raises instead of being served by another
backend or on another device, so a run can never pass off the plain
version as the kernel.
"""

from __future__ import annotations

import threading

import torch

from .base import Backend

__all__ = ["register_backend", "unregister_backend", "get_backend",
           "available_backends", "resolve_backend"]

_REGISTRY: dict[str, Backend] = {}
_MUTATE_LOCK = threading.Lock()


def register_backend(backend: Backend, *, overwrite: bool = False) -> Backend:
    with _MUTATE_LOCK:
        if not overwrite and backend.name in _REGISTRY:
            raise ValueError(f"backend {backend.name!r} already registered")
        _REGISTRY[backend.name] = backend
    return backend


def unregister_backend(name: str) -> None:
    with _MUTATE_LOCK:
        _REGISTRY.pop(name, None)


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no backend {name!r}; registered: "
                       f"{available_backends()}") from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_backend(backend: str | Backend,
                    device: torch.device | str | None = None) -> Backend:
    """The requested backend (bound to ``device`` when given).  Raises
    ``KeyError`` when it is not registered and ``RuntimeError`` when its
    device is absent on this host."""
    be = backend if isinstance(backend, Backend) else get_backend(backend)
    if device is not None:
        be = be.on(device)
    if not be.is_available():
        raise RuntimeError(
            f"backend {be.name!r} runs on {be.device}, which this host does "
            f"not have (torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}); pass device='cpu' to run its "
            f"plain version on the CPU")
    return be
