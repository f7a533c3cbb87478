"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``kernels/csrc/`` compiles, at its first use in a process,
into one shared library with a plain C interface under ``build/repro_torch/``
at the root of the checkout, named by a hash of the source, the headers of
``csrc/`` and the flags, so an edited source or header builds anew and an
unchanged one loads at once.  ``nvcc``'s ``-Xptxas -v`` report
(registers, shared memory and spill bytes of every instantiation) is kept
beside the library.  Nothing is built when a module
is imported: the CPU tests import every module on hosts with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "build", "load", "launcher", "launch_grid",
           "nvcc_path", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the port's "
                           "kernels are built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _library_path(name: str) -> Path:
    # the headers of csrc/ count towards every source's hash
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    parts.append(" ".join(NVCC_FLAGS).encode())
    digest = hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/{name}.cu`` unless its library is built; returns the
    library's path.  Raises with nvcc's output when the build fails."""
    lib = _library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib


def launcher(name: str, argtypes: list, *, source: str | None = None,
             symbol: str | None = None):
    """The launcher ``symbol`` (default ``repro_{name}_f32``) of
    ``csrc/{source}.cu`` (``source`` defaults to ``name``), its argument
    types set once under the build lock, so threads that launch together
    at first use never call it half configured.  Every launcher returns a
    ``cudaError_t`` and takes, last, an ``int[3]`` it writes the launched
    grid to (:func:`launch_grid`)."""
    fn = _FUNCS.get(name)
    if fn is not None:
        return fn
    lib = load(source or name)
    with _LOCK:
        fn = _FUNCS.get(name)
        if fn is None:
            fn = getattr(lib, symbol or f"repro_{name}_f32")
            fn.argtypes = [*argtypes, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            _FUNCS[name] = fn
    return fn


def launch_grid():
    """A fresh ``int[3]`` for a launcher to write its grid to."""
    return (ctypes.c_int * 3)()


def ptxas_report(name: str) -> str:
    """``nvcc -Xptxas -v`` output of the build of ``csrc/{name}.cu``."""
    return _library_path(name).with_suffix(".ptxas.txt").read_text()
