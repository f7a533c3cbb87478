"""SYMM on the H100: ``O = alpha * sym(A) @ B + beta * C`` with A stored in
its lower triangle, a CUDA C++ kernel written for Hopper
(``csrc/symm.cu``, on the GEMM's mainloop ``csrc/sgemm_mainloop.cuh``),
tiled by the knob's ``bm x bn`` output tile.

It takes the place of the reference package's Pallas kernel
(``src/repro/kernels/symm.py::symm_pallas``) with the same semantics:

* A is ``(m, m)`` or ``(batch, m, m)``, read only on and below its
  diagonal; B is ``(m, n)`` or ``(batch, m, n)``, stacked as A is.
* Ragged m/n need no padding: the kernel masks its edge tiles and the
  ragged contraction tail (the contraction dimension is m itself).
* C is read only when ``beta != 0`` and a C was given; it has the output's
  shape.  The output is float32, accumulated in float32.

:func:`symm` launches the kernel for CUDA tensors and records the launch
and its grid with :func:`~repro_torch.kernels.introspect.record_launch`; for
CPU tensors it computes :func:`symm_plain`, the plain PyTorch version the
tests and the chip smoke compare the kernel with.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.knobs import hopper_2d_knob_space

from . import _build
from .gemm import vec_aligned
from .introspect import launch_events, record_launch
from .ref import sym_lower

__all__ = ["symm", "symm_plain", "TILES"]

#: the ``(bm, bn)`` output tiles ``csrc/symm.cu`` is instantiated for
TILES = frozenset((k["bm"], k["bn"]) for k in hopper_2d_knob_space("symm"))

#: grid y and z limits of a launch (m-tiles and batch)
_MAX_GRID_YZ = 65535

_C_LL = ctypes.c_longlong
_ARGTYPES = [ctypes.c_int, ctypes.c_int,                         # bm, bn
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # A, B, C
             ctypes.c_void_p,                                    # O
             ctypes.c_int, ctypes.c_int, ctypes.c_int,           # m, n, batch
             _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL,
             ctypes.c_float, ctypes.c_float, ctypes.c_int,       # alpha..
             ctypes.c_int,                                       # vec
             ctypes.c_void_p,                                    # stream
             ctypes.c_void_p, ctypes.c_void_p]                   # events


def symm_plain(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor | None = None, *, alpha: float = 1.0,
               beta: float = 0.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``alpha * sym(A) @ B +
    beta * C`` in float32."""
    out = alpha * torch.matmul(sym_lower(a.float()), b.float())
    if c is not None and beta != 0.0:
        out = out + beta * c.float()
    return out.to(a.dtype)


def _check(a, b, c, bm, bn) -> tuple[int, int, int | None]:
    if (bm, bn) not in TILES:
        raise ValueError(f"no SYMM kernel for tile bm={bm} bn={bn}")
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"A and B must both be 2-D or both 3-D, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    batch = a.shape[0] if a.dim() == 3 else None
    m, m2 = a.shape[-2:]
    mb, n = b.shape[-2:]
    if m != m2 or m != mb or (batch is not None and b.shape[0] != batch):
        raise ValueError(f"A {tuple(a.shape)} must be square with B "
                         f"{tuple(b.shape)} of as many rows and items")
    for t in (a, b) if c is None else (a, b, c):
        if t.device != a.device:
            raise ValueError(f"operands on {t.device} and {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the SYMM kernel takes float32, got {t.dtype}")
        if t.numel() and t.stride(-1) != 1:
            raise ValueError("the SYMM kernel needs rows with unit inner "
                             f"stride, got strides {t.stride()}")
    if c is not None and tuple(c.shape) != tuple(b.shape):
        raise ValueError(f"C {tuple(c.shape)} must have the output's shape "
                         f"{tuple(b.shape)}")
    if -(-m // bm) > _MAX_GRID_YZ or (batch or 1) > _MAX_GRID_YZ:
        raise ValueError(f"m={m} or batch={batch} beyond one launch's grid")
    return m, n, batch


def symm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None, *,
         bm: int, bn: int, alpha: float = 1.0,
         beta: float = 0.0) -> torch.Tensor:
    """``alpha * sym(A) @ B + beta * C`` under the output tile ``bm x bn``.

    On CUDA tensors this launches ``csrc/symm.cu`` on the current stream
    (no synchronisation) and raises if the launch is refused; on CPU
    tensors it returns :func:`symm_plain`."""
    m, n, batch = _check(a, b, c, bm, bn)
    if a.device.type == "cpu":
        return symm_plain(a, b, c, alpha=alpha, beta=beta)
    if a.device.type != "cuda":
        raise ValueError(f"no SYMM kernel for device {a.device}")
    has_c = c is not None and beta != 0.0
    out = torch.empty(b.shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    stacked = batch is not None
    sab, sbb = (a.stride(0), b.stride(0)) if stacked else (0, 0)
    vec = vec_aligned((a, a.stride(-2), sab), (b, b.stride(-2), sbb))
    grid = _build.launch_grid()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch = _build.launcher("symm", _ARGTYPES)
        events = launch_events()
        rc = launch(
            bm, bn, a.data_ptr(), b.data_ptr(),
            c.data_ptr() if has_c else None, out.data_ptr(), m, n, batch or 1,
            sab, a.stride(-2), sbb, b.stride(-2),
            c.stride(0) if has_c and stacked else 0,
            c.stride(-2) if has_c else 0,
            out.stride(0) if stacked else 0, out.stride(-2),
            float(alpha), float(beta), int(has_c), int(vec), stream, *events, grid)
    if rc != 0:
        raise RuntimeError(f"SYMM kernel launch failed with CUDA error {rc} "
                           f"(tile {bm}x{bn}, A {tuple(a.shape)}, "
                           f"B {tuple(b.shape)})")
    record_launch("symm", grid)
    return out
