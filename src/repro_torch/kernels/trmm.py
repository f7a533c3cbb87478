"""TRMM on the H100: ``O = alpha * tril(A) @ B`` (left, lower, non-unit),
with CUDA C++ kernels written for Hopper on the GEMM's f32 mainloop
(``csrc/sgemm_mainloop.cuh``), tiled by the knob's ``bm x bn`` output tile.

It takes the place of the reference package's Pallas kernels
(``src/repro/kernels/trmm.py::trmm_pallas``) with the same semantics and
the same three variants, which the ADSALA knob selects:

* ``full`` (``csrc/trmm.cu``): every block walks the whole contraction and
  multiplies zero-filled A tiles past the diagonal (without reading A
  there), the reference's uniform pipeline;
* ``tri`` (``csrc/trmm.cu``): each pass of rows stops at the end of its
  rows' stored columns, so no arithmetic is done past the diagonal;
* ``tri_packed`` (``csrc/trmm_packed.cu``): about half of ``tri``'s blocks,
  each computing the tile of row block ``p`` and then that of row block
  ``nb - 1 - p``, so that every block does about the same live work.  It
  equals ``tri`` bit for bit.

Both kernels stage tril(A) through one producer (``csrc/trmm_tile.cuh``):
the GEMM's row-major copies with a per-row column limit, so A is read only
on and below its diagonal and whatever it holds above changes no bit.  A
is ``(m, m)`` or ``(batch, m, m)``; B is ``(m, n)`` or ``(batch, m, n)``,
stacked as A is.  Ragged m and n need no padding: the kernels mask A's
columns and B's rows alike past m.  When A, B and their strides are
16-byte aligned (:func:`~repro_torch.kernels.gemm.vec_aligned`, no copy)
the kernels move 4 floats a copy, else one, with the same bits.  The
result is a new float32 tensor, accumulated in float32.

:func:`trmm` launches a kernel for CUDA tensors and records the launch and
its grid under the kernel's name with
:func:`~repro_torch.kernels.introspect.record_launch`; for CPU tensors it
computes :func:`trmm_plain`, the plain PyTorch version the tests and the
chip smoke compare the kernels with.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.knobs import HOPPER_2D_VARIANTS, hopper_2d_knob_space

from . import _build
from .gemm import vec_aligned
from .introspect import launch_events, record_launch

__all__ = ["trmm", "trmm_plain", "TILES", "VARIANTS"]

#: the ``(bm, bn)`` output tiles both kernels are instantiated for
TILES = frozenset((k["bm"], k["bn"]) for k in hopper_2d_knob_space("trmm"))
VARIANTS = HOPPER_2D_VARIANTS["trmm"]

#: grid y and z limits of a launch (m-tiles and batch)
_MAX_GRID_YZ = 65535

_C_LL = ctypes.c_longlong
_COMMON = [ctypes.c_int, ctypes.c_int,                          # bm, bn
           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # A, B, O
           ctypes.c_int, ctypes.c_int, ctypes.c_int,            # m, n, batch
           _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL,            # strides
           ctypes.c_float]                                      # alpha
_TAIL = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]    # stream, events
_ARGTYPES = {"trmm": _COMMON + [ctypes.c_int, ctypes.c_int]     # tri, vec
             + _TAIL,
             "trmm_packed": _COMMON + [ctypes.c_int] + _TAIL}   # vec


def trmm_plain(a: torch.Tensor, b: torch.Tensor, *,
               alpha: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version of the kernels: ``alpha * (tril(A) @ B)``
    in float32."""
    out = alpha * torch.matmul(torch.tril(a.float()), b.float())
    return out.to(a.dtype)


def _check(a, b, bm, bn, variant) -> tuple[int, int, int | None]:
    if (bm, bn) not in TILES:
        raise ValueError(f"no TRMM kernel for tile bm={bm} bn={bn}")
    if variant not in VARIANTS:
        raise ValueError(f"no TRMM variant {variant!r}")
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"A and B must both be 2-D or both 3-D, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    batch = a.shape[0] if a.dim() == 3 else None
    m, m2 = a.shape[-2:]
    mb, n = b.shape[-2:]
    if m != m2 or m != mb or (batch is not None and b.shape[0] != batch):
        raise ValueError(f"A {tuple(a.shape)} must be square with B "
                         f"{tuple(b.shape)} of as many rows and items")
    for t in (a, b):
        if t.device != a.device:
            raise ValueError(f"operands on {t.device} and {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the TRMM kernels take float32, got {t.dtype}")
        if t.numel() and t.stride(-1) != 1:
            raise ValueError("the TRMM kernels need rows with unit inner "
                             f"stride, got strides {t.stride()}")
    if -(-m // bm) > _MAX_GRID_YZ or (batch or 1) > _MAX_GRID_YZ:
        raise ValueError(f"m={m} or batch={batch} beyond one launch's grid")
    return m, n, batch


def trmm(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
         alpha: float = 1.0, variant: str = "full") -> torch.Tensor:
    """``alpha * tril(A) @ B`` under the output tile ``bm x bn`` and
    ``variant``.

    On CUDA tensors this launches ``csrc/trmm.cu`` (``full``, ``tri``) or
    ``csrc/trmm_packed.cu`` (``tri_packed``) on the current stream (no
    synchronisation) and raises if the launch is refused; on CPU tensors it
    returns :func:`trmm_plain`."""
    m, n, batch = _check(a, b, bm, bn, variant)
    if a.device.type == "cpu":
        return trmm_plain(a, b, alpha=alpha)
    if a.device.type != "cuda":
        raise ValueError(f"no TRMM kernel for device {a.device}")
    out = torch.empty(b.shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        _launch(a, b, out, m, n, batch, bm=bm, bn=bn, alpha=alpha,
                variant=variant,
                stream=torch.cuda.current_stream().cuda_stream)
    return out


def _launch(a, b, out, m, n, batch, *, bm, bn, alpha, variant,
            stream) -> None:
    """Launch the kernel of ``variant`` on checked operands and ``out`` on
    ``stream``, and record the launch."""
    stacked = batch is not None
    sab, sbb = (a.stride(0), b.stride(0)) if stacked else (0, 0)
    vec = vec_aligned((a, a.stride(-2), sab), (b, b.stride(-2), sbb))
    kernel = "trmm_packed" if variant == "tri_packed" else "trmm"
    flags = (int(vec),) if kernel == "trmm_packed" \
        else (int(variant == "tri"), int(vec))
    grid = _build.launch_grid()
    launch = _build.launcher(kernel, _ARGTYPES[kernel])
    events = launch_events()
    rc = launch(
        bm, bn, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n,
        batch or 1, sab, a.stride(-2), sbb, b.stride(-2),
        out.stride(0) if stacked else 0, out.stride(-2),
        float(alpha), *flags, stream, *events, grid)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error "
                           f"{rc} (tile {bm}x{bn}, variant {variant}, "
                           f"A {tuple(a.shape)}, B {tuple(b.shape)})")
    record_launch(kernel, grid)
