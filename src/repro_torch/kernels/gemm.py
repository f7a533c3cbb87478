"""GEMM on the H100: ``O = alpha * A @ B + beta * C`` with a CUDA C++ kernel
written for Hopper (``csrc/gemm.cu``), tiled by the knob ``(bm, bk, bn)``.

It takes the place of the reference package's Pallas kernel
(``src/repro/kernels/gemm.py::gemm_pallas``) with the same semantics:

* A is ``(m, k)`` or ``(batch, m, k)``; B is ``(k, n)`` or ``(batch, k, n)``.
  A 2-D B against a stacked A is one weight shared by the whole stack (the
  model-serving linear), read with batch stride 0 and never copied.
* Ragged m/n/k need no padding: the kernel masks its edge tiles.
* C is read only when ``beta != 0`` and a C was given; it has the output's
  shape.  The output has A's dtype (float32, the only dtype the kernel
  takes) and is accumulated in float32.

:func:`gemm` launches the kernel for CUDA tensors and counts the launch in
:data:`LAUNCHES`; for CPU tensors it computes :func:`gemm_plain`, the plain
PyTorch version the tests and the chip smoke compare the kernel with.
"""

from __future__ import annotations

import ctypes
import itertools

import torch

from repro_torch.core.knobs import HOPPER_TILES_K, HOPPER_TILES_MN

from . import _build

__all__ = ["gemm", "gemm_plain", "LAUNCHES", "TILES"]

#: kernel launches made by :func:`gemm` (one per call on a CUDA tensor)
LAUNCHES = 0

#: the ``(bm, bk, bn)`` tiles ``csrc/gemm.cu`` is instantiated for
TILES = frozenset(itertools.product(HOPPER_TILES_MN, HOPPER_TILES_K,
                                    HOPPER_TILES_MN))

#: grid y and z limits of a launch (m-tiles and batch)
_MAX_GRID_YZ = 65535

_C_LL = ctypes.c_longlong
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int,         # bm, bk, bn
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # A, B, C
             ctypes.c_void_p,                                    # O
             ctypes.c_int, ctypes.c_int, ctypes.c_int,           # m, n, k
             ctypes.c_int,                                       # batch
             _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL,
             ctypes.c_float, ctypes.c_float, ctypes.c_int,       # alpha..
             ctypes.c_void_p]                                    # stream


def _launcher():
    lib = _build.load("gemm")
    fn = lib.repro_gemm_f32
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def gemm_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
               *, alpha: float = 1.0, beta: float = 0.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel, same batch and shared-B
    semantics: ``alpha * (A @ B) + beta * C`` in float32, cast to A's
    dtype."""
    out = alpha * torch.matmul(a.float(), b.float())
    if c is not None and beta != 0.0:
        out = out + beta * c.float()
    return out.to(a.dtype)


def _check(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None,
           bm: int, bk: int, bn: int) -> tuple[int, int, int, int | None]:
    if (bm, bk, bn) not in TILES:
        raise ValueError(f"no GEMM kernel for tile bm={bm} bk={bk} bn={bn}")
    if a.dim() not in (2, 3) or b.dim() not in (2, 3):
        raise ValueError(f"A and B must be 2-D or 3-D, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    batch = a.shape[0] if a.dim() == 3 else None
    if b.dim() == 3 and (batch is None or b.shape[0] != batch):
        raise ValueError(f"B {tuple(b.shape)} is stacked but A "
                         f"{tuple(a.shape)} is not, or their stacks differ")
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"inner dims differ: A {tuple(a.shape)}, "
                         f"B {tuple(b.shape)}")
    tensors = (a, b) if c is None else (a, b, c)
    for t in tensors:
        if t.device != a.device:
            raise ValueError(f"operands on {t.device} and {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the GEMM kernel takes float32, got {t.dtype}")
        if t.numel() and t.stride(-1) != 1:
            raise ValueError("the GEMM kernel needs rows with unit inner "
                             f"stride, got strides {t.stride()}")
    if c is not None:
        want = (batch, m, n) if batch is not None else (m, n)
        if tuple(c.shape) != want:
            raise ValueError(f"C {tuple(c.shape)} must have the output's "
                             f"shape {want}")
    if -(-m // bm) > _MAX_GRID_YZ or (batch or 1) > _MAX_GRID_YZ:
        raise ValueError(f"m={m} or batch={batch} beyond one launch's grid")
    return m, k, n, batch


def gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None, *,
         bm: int, bk: int, bn: int, alpha: float = 1.0, beta: float = 0.0,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """``alpha * A @ B + beta * C`` under the tile ``(bm, bk, bn)``, into
    ``out`` when given (a view with the output's shape and unit inner
    stride, such as a block row of a larger matrix; it may not overlap the
    operands), else into a new tensor.

    On CUDA tensors this launches ``csrc/gemm.cu`` on the current stream
    (no synchronisation) and raises if the launch is refused; on CPU
    tensors it returns :func:`gemm_plain`."""
    global LAUNCHES
    m, k, n, batch = _check(a, b, c, bm, bk, bn)
    shape = a.shape[:-1] + (n,)
    if out is not None and (tuple(out.shape) != tuple(shape)
                            or out.dtype != a.dtype or out.device != a.device
                            or (out.numel() and out.stride(-1) != 1)):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} with strides {out.stride()} cannot "
                         f"take the {tuple(shape)} result")
    if a.device.type == "cpu":
        res = gemm_plain(a, b, c, alpha=alpha, beta=beta)
        return res if out is None else out.copy_(res)
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM kernel for device {a.device}")
    has_c = c is not None and beta != 0.0
    if out is None:
        out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    stacked = batch is not None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launcher()(
            bm, bk, bn, a.data_ptr(), b.data_ptr(),
            c.data_ptr() if has_c else None, out.data_ptr(),
            m, n, k, batch or 1,
            a.stride(0) if stacked else 0, a.stride(-2),
            b.stride(0) if b.dim() == 3 else 0, b.stride(-2),
            c.stride(0) if has_c and stacked else 0,
            c.stride(-2) if has_c else 0,
            out.stride(0) if stacked else 0, out.stride(-2),
            float(alpha), float(beta), int(has_c), stream)
    if rc != 0:
        raise RuntimeError(f"GEMM kernel launch failed with CUDA error {rc} "
                           f"(tile {bm}x{bk}x{bn}, A {tuple(a.shape)}, "
                           f"B {tuple(b.shape)})")
    LAUNCHES += 1
    return out
