"""SYRK / SYR2K on the H100, lower-triangle rank-k updates, with CUDA C++
kernels written for Hopper on the GEMM's f32 mainloop
(``csrc/sgemm_mainloop.cuh``):

  syrk : O = alpha * A @ A^T + beta * C            A (n, k), C (n, n)
  syr2k: O = alpha * (A @ B^T + B @ A^T) + beta * C

They take the place of the reference package's Pallas kernels
(``src/repro/kernels/syrk.py``) with the same three variants, which the
ADSALA knob selects:

* ``full`` (``csrc/rank_k.cu``): every output tile is computed, both
  triangles, and C is added as given, both triangles (the reference's
  ``full`` reads C as it is; the other variants read it as lower-stored).
* ``tri`` (``csrc/rank_k.cu``): the whole tile grid is launched, the tiles
  above the diagonal do no arithmetic, C's strict upper triangle counts as
  zero, and each lower tile is stored with its mirror in the kernel's
  epilogue (the reference's ``tril + tril^T`` post-pass, by selection): one
  launch, no pass after it.
* ``tri_packed`` (``csrc/rank_k_packed.cu``): only the ``nb (nb + 1) / 2``
  lower tiles are launched, each stored with its mirror by the same
  epilogue.  It equals ``tri`` bit for bit.

Both kernels run one tile body (``csrc/rank_k_tile.cuh``): the A side of a
tile staged as the GEMM stages A, the B side (rows of A again, or of B) as
rows with the contraction innermost; syr2k as one contraction of twice the
steps, all ``A B^T`` products of an element before all ``B A^T`` ones.  The
knob's ``bm`` is the square output tile and its ``bn`` the contraction
block (the reference's ``bk = kb["bn"]``); :func:`rank_k_params` gives the
launch parameters a tile compiles to.  A leading batch axis is the kernels'
grid z; ragged n and k need no padding.  When the operands and their
strides are 16-byte aligned (:func:`~repro_torch.kernels.gemm.vec_aligned`,
no copy) the kernels move 4 floats a copy, else one, with the same bits.
C is read only when ``beta != 0`` and a C was given.

:func:`syrk` and :func:`syr2k` launch a kernel for CUDA tensors and record
the launch and its grid under the kernel's name with
:func:`~repro_torch.kernels.introspect.record_launch`; for CPU tensors they
compute :func:`rank_k_plain`, the plain PyTorch version the tests and the
chip smoke compare the kernels with.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.knobs import HOPPER_2D_VARIANTS, hopper_2d_knob_space

from . import _build
from .gemm import mainloop_params, ring_stages, vec_aligned
from .introspect import launch_events, record_launch
from .ref import sym_lower

__all__ = ["syrk", "syr2k", "rank_k_plain", "rank_k_params", "TILES",
           "VARIANTS"]

#: the ``(bm, bk)`` tiles both kernels are instantiated for (bk = knob bn)
TILES = frozenset((k["bm"], k["bn"]) for k in hopper_2d_knob_space("syrk"))
VARIANTS = HOPPER_2D_VARIANTS["syrk"]

#: grid x / y / z limits of a launch
_MAX_GRID_X = 2 ** 31 - 1
_MAX_GRID_YZ = 65535

_C_LL = ctypes.c_longlong
_COMMON = [ctypes.c_int, ctypes.c_int,                          # bm, bk
           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # A, B, C
           ctypes.c_void_p,                                     # O
           ctypes.c_int, ctypes.c_int, ctypes.c_int,            # n, k, batch
           _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL,
           ctypes.c_float, ctypes.c_float,                      # alpha, beta
           ctypes.c_int]                                        # two
_TAIL = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]    # stream, events
_ARGTYPES = {"rank_k": _COMMON + [ctypes.c_int, ctypes.c_int,   # tri, has_c
                                  ctypes.c_int] + _TAIL,        # vec
             "rank_k_packed": _COMMON + [ctypes.c_int,          # has_c
                                         ctypes.c_int] + _TAIL}  # vec


def rank_k_params(bm: int, bk: int) -> dict:
    """The launch parameters ``csrc/rank_k_tile.cuh`` derives from the tile
    ``(bm, bk)``: the mainloop's ``bm x bm`` tile with contraction step
    ``bk`` (:func:`~repro_torch.kernels.gemm.mainloop_params`: threads,
    register tile, one pass), but a stage of ``bm x bk`` A floats and
    ``bm x (bk + 4)`` B floats (B staged as rows, padded), as many stages of
    2-4 as fit in the ring budget, and the epilogue's parked
    ``bm x (bm + 1)`` tile, which reuses the ring."""
    p = mainloop_params(bm, bk, bm)
    stage = 4 * bm * (2 * bk + 4)
    stages = ring_stages(stage)
    p.update(stages=stages, smem=stages * stage, park=4 * bm * (bm + 1))
    return p


def rank_k_plain(a: torch.Tensor, b: torch.Tensor | None = None,
                 c: torch.Tensor | None = None, *, alpha: float = 1.0,
                 beta: float = 0.0, variant: str = "full") -> torch.Tensor:
    """The plain PyTorch version of the kernels, per variant: syrk when
    ``b`` is None, else syr2k, in float32.  ``full`` adds C as given;
    ``tri`` and ``tri_packed`` add its lower triangle and mirror the
    result's lower triangle into the upper one."""
    if variant not in VARIANTS:
        raise ValueError(f"no rank-k variant {variant!r}")
    a = a.float()
    if b is None:
        prod = torch.matmul(a, a.mT)
    else:
        b = b.float()
        prod = torch.matmul(a, b.mT) + torch.matmul(b, a.mT)
    out = alpha * prod
    if c is not None and beta != 0.0:
        c = c.float()
        out = out + beta * (c if variant == "full" else torch.tril(c))
    if variant != "full":
        out = sym_lower(out)
    return out


def _check(a, b, c, bm, bk, variant) -> tuple[int, int, int | None]:
    if (bm, bk) not in TILES:
        raise ValueError(f"no rank-k kernel for tile bm={bm} bk={bk}")
    if variant not in VARIANTS:
        raise ValueError(f"no rank-k variant {variant!r}")
    if a.dim() not in (2, 3):
        raise ValueError(f"A must be 2-D or 3-D, got {tuple(a.shape)}")
    if b is not None and tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"B {tuple(b.shape)} must have A's shape "
                         f"{tuple(a.shape)}")
    batch = a.shape[0] if a.dim() == 3 else None
    n, k = a.shape[-2:]
    for t in (a, b, c):
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"operands on {t.device} and {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the rank-k kernels take float32, got {t.dtype}")
        if t.numel() and t.stride(-1) != 1:
            raise ValueError("the rank-k kernels need rows with unit inner "
                             f"stride, got strides {t.stride()}")
    want = a.shape[:-1] + (n,)
    if c is not None and tuple(c.shape) != tuple(want):
        raise ValueError(f"C {tuple(c.shape)} must have the output's shape "
                         f"{tuple(want)}")
    nb = -(-n // bm)
    if (batch or 1) > _MAX_GRID_YZ or nb > _MAX_GRID_YZ \
            or nb * (nb + 1) // 2 > _MAX_GRID_X:
        raise ValueError(f"n={n} or batch={batch} beyond one launch's grid")
    return n, k, batch


def _rank_k(a, b, c, *, bm, bk, alpha, beta, variant) -> torch.Tensor:
    n, k, batch = _check(a, b, c, bm, bk, variant)
    if a.device.type == "cpu":
        return rank_k_plain(a, b, c, alpha=alpha, beta=beta,
                            variant=variant)
    if a.device.type != "cuda":
        raise ValueError(f"no rank-k kernel for device {a.device}")
    out = torch.empty(a.shape[:-1] + (n,), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        _launch(a, b, c, out, n, k, batch, bm=bm, bk=bk, alpha=alpha,
                beta=beta, variant=variant,
                stream=torch.cuda.current_stream().cuda_stream)
    return out


def _launch(a, b, c, out, n, k, batch, *, bm, bk, alpha, beta, variant,
            stream) -> None:
    """Launch the kernel of ``variant`` on checked operands and ``out`` on
    ``stream``, and record the launch: one launch, whatever the variant."""
    has_c = c is not None and beta != 0.0
    two = b is not None
    stacked = batch is not None
    sab = a.stride(0) if stacked else 0
    sbb = b.stride(0) if two and stacked else 0
    aligned = [(a, a.stride(-2), sab)]
    if two:
        aligned.append((b, b.stride(-2), sbb))
    vec = vec_aligned(*aligned)
    kernel = "rank_k_packed" if variant == "tri_packed" else "rank_k"
    flags = (int(two), int(variant == "tri"), int(has_c), int(vec)) \
        if kernel == "rank_k" else (int(two), int(has_c), int(vec))
    grid = _build.launch_grid()
    launch = _build.launcher(kernel, _ARGTYPES[kernel])
    events = launch_events()
    rc = launch(
        bm, bk, a.data_ptr(), b.data_ptr() if two else None,
        c.data_ptr() if has_c else None, out.data_ptr(), n, k, batch or 1,
        sab, a.stride(-2), sbb, b.stride(-2) if two else 0,
        c.stride(0) if has_c and stacked else 0,
        c.stride(-2) if has_c else 0,
        out.stride(0) if stacked else 0, out.stride(-2),
        float(alpha), float(beta), *flags, stream, *events, grid)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error "
                           f"{rc} (tile {bm}x{bk}, variant {variant}, "
                           f"A {tuple(a.shape)})")
    record_launch(kernel, grid)


def syrk(a: torch.Tensor, c: torch.Tensor | None = None, *, bm: int, bk: int,
         alpha: float = 1.0, beta: float = 0.0,
         variant: str = "full") -> torch.Tensor:
    """``alpha * A @ A^T + beta * C`` under the output tile ``bm``, the
    contraction block ``bk`` and ``variant``.  Launches a kernel on the
    current stream for CUDA tensors (no synchronisation; raises if the
    launch is refused); computes :func:`rank_k_plain` for CPU tensors."""
    return _rank_k(a, None, c, bm=bm, bk=bk, alpha=alpha, beta=beta,
                   variant=variant)


def syr2k(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None, *,
          bm: int, bk: int, alpha: float = 1.0, beta: float = 0.0,
          variant: str = "full") -> torch.Tensor:
    """``alpha * (A @ B^T + B @ A^T) + beta * C``; as :func:`syrk`."""
    return _rank_k(a, b, c, bm=bm, bk=bk, alpha=alpha, beta=beta,
                   variant=variant)
