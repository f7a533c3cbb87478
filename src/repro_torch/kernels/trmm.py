"""TRMM on the H100: ``O = alpha * tril(A) @ B`` (left, lower, non-unit),
with CUDA C++ kernels written for Hopper, tiled by the knob's ``bm x bn``
output tile: on the GEMM's f32 mainloop (``csrc/sgemm_mainloop.cuh``) for
float32 operands, on the bf16 GEMM's wgmma + TMA mainloop
(``csrc/bf16_wgmma_mainloop.cuh``) for bfloat16.

It takes the place of the reference package's Pallas kernels
(``src/repro/kernels/trmm.py::trmm_pallas``) with the same semantics and
the same three variants, which the ADSALA knob selects:

* ``full`` (``csrc/trmm.cu``; bf16 ``csrc/trmm_bf16.cu``): every block
  walks the whole contraction and multiplies zero-filled A tiles past the
  diagonal (without reading A there), the reference's uniform pipeline;
* ``tri`` (the same kernels): each pass of rows stops at the end of its
  rows' stored columns, so no arithmetic is done past the diagonal;
* ``tri_packed`` (``csrc/trmm_packed.cu``; bf16
  ``csrc/trmm_packed_bf16.cu``): about half of ``tri``'s blocks,
  each computing the tile of row block ``p`` and then that of row block
  ``nb - 1 - p``, so that every block does about the same live work.  It
  equals ``tri`` bit for bit.

The kernels of a dtype stage tril(A) through one producer
(``csrc/trmm_tile.cuh``, bf16 ``csrc/trmm_tile_bf16.cuh``), so whatever A
holds above its diagonal changes no bit.  float32: the GEMM's row-major
copies with a per-row column limit, A read only on and below its
diagonal.  bfloat16: wgmma reads A's steps from shared memory, each step
(64 contraction indices of a pass of rows) staged by where it lies
(:func:`step_plan`): below the diagonal TMA's boxes as the GEMM's,
across it TMA's boxes with the part above the diagonal then zeroed by the
threads, above it (``full`` only) zeros; a pass's contraction ends at m
(``full``) or at the end of its rows (``tri``, ``tri_packed``).  The bf16
kernels map a launched block to its tile by groups of
:data:`BLOCK_GROUP` column tiles (:func:`tile_of_block`), so that the
blocks in flight share B's columns in L2.  A is ``(m, m)`` or ``(batch,
m, m)``; B is ``(m, n)`` or ``(batch, m, n)``, stacked as A is.  Ragged m
and n need no padding: the kernels mask A's columns and B's rows alike
past m.  When A, B and their strides are 16-byte aligned
(:func:`~repro_torch.kernels.gemm.vec_aligned`, no copy) the kernels
move 16 bytes a copy (bf16: TMA's boxes), else one element, with the same
bits.
A and B are both float32 or both bfloat16; the result is a new tensor of
A's dtype, accumulated in float32 (bf16 rounded once, at the store, as
the reference's kernel writes its float32 scratch).

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

__all__ = ["trmm", "trmm_plain", "step_plan", "block_rows",
           "tile_of_block", "TILES", "VARIANTS", "KERNEL_OF", "BF16_STEP",
           "BLOCK_GROUP"]

#: the ``(bm, bn)`` output tiles every kernel is instantiated for
TILES = frozenset((k["bm"], k["bn"]) for k in hopper_2d_knob_space("trmm"))
VARIANTS = HOPPER_2D_VARIANTS["trmm"]
#: the operand dtypes the TRMM kernels take: dtype -> {form: (kernel, C
#: launcher)}, the form ``trmm`` (full, tri) or ``trmm_packed``
#: (tri_packed)
KERNEL_OF = {torch.float32: {"trmm": ("trmm", "repro_trmm_f32"),
                             "trmm_packed": ("trmm_packed",
                                             "repro_trmm_packed_f32")},
             torch.bfloat16: {"trmm": ("trmm_bf16", "repro_trmm_bf16"),
                              "trmm_packed": ("trmm_packed_bf16",
                                              "repro_trmm_packed_bf16")}}

#: contraction indices a step of the bf16 kernels holds
#: (``csrc/trmm_tile_bf16.cuh`` ``BK``)
BF16_STEP = 64
#: column tiles of a group in the bf16 kernels' block order (``kGroup``)
BLOCK_GROUP = 16

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
    in float32, cast to A's dtype."""
    out = alpha * torch.matmul(torch.tril(a.float()), b.float())
    return out.to(a.dtype)


def block_rows(variant: str, m: int, bm: int, rank: int) -> list[int]:
    """The first rows of the output tiles that the block of row block
    ``rank`` (``full``, ``tri``) or of pair ``rank`` (``tri_packed``: row
    blocks ``rank`` and ``nb - 1 - rank``, once when they are one)
    computes, in order."""
    lo, hi = rank * bm, (-(-m // bm) - 1 - rank) * bm
    return [lo] if variant != "tri_packed" or hi == lo else [lo, hi]


def step_plan(variant: str, m: int, bm: int,
              rows: list[int]) -> list[tuple[int, list[str]]]:
    """The passes of a bf16 block computing the tiles whose first rows are
    ``rows`` (:func:`block_rows`), as ``(prow0, kinds)`` in the order they
    run through the block's ring: the mirror of
    ``csrc/trmm_tile_bf16.cuh``'s ``TrmmSteps`` and its producer.

    A tile runs passes of ``min(bm, 128)`` rows that start inside m.  The
    contraction of the pass at ``prow0`` ends at m under ``full`` and at
    ``min(prow0 + pass rows, m)`` under ``tri`` and ``tri_packed``; its
    steps of :data:`BF16_STEP` indices from 0 are each ``"below"`` the
    diagonal (every element stored: ``k0 + 64 <= prow0 + 1``), ``"above"``
    it (every element zero: ``k0 >= prow0 +`` pass rows) or ``"across"``
    it."""
    pm = min(bm, 128)
    plan = []
    for row0 in rows:
        for prow0 in range(row0, min(row0 + bm, m), pm):
            kend = m if variant == "full" else min(prow0 + pm, m)
            plan.append((prow0, [
                "below" if k0 + BF16_STEP <= prow0 + 1 else
                "above" if k0 >= prow0 + pm else "across"
                for k0 in range(0, kend, BF16_STEP)]))
    return plan


def tile_of_block(variant: str, nx: int, nb: int,
                  block) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(rank, column tile)`` that the bf16 kernels' launched blocks
    ``block`` (linear indices ``y * nx + x``, an int or a tensor) compute,
    in a grid of ``nx`` column tiles and ``nb`` row blocks: the row block
    (``full``, ``tri``) or the pair (``tri_packed``, ``ceil(nb / 2)`` of
    them): the mirror of ``csrc/trmm_bf16.cu``'s and
    ``csrc/trmm_packed_bf16.cu``'s ``block_tile``.

    Groups of :data:`BLOCK_GROUP` column tiles (the last may hold fewer),
    each walked row by row with its columns fastest: from the last row
    block up under ``full`` and ``tri`` (the longest first), from the
    first pair on under ``tri_packed``."""
    t = torch.as_tensor(block, dtype=torch.int64)
    ny = nb if variant != "tri_packed" else -(-nb // 2)
    x0 = t // (BLOCK_GROUP * ny) * BLOCK_GROUP
    g = torch.clamp(nx - x0, max=BLOCK_GROUP)
    u = t - x0 * ny
    rank = u // g
    return (rank if variant == "tri_packed" else nb - 1 - rank), x0 + u % g


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
    if a.dtype not in KERNEL_OF or b.dtype != a.dtype:
        raise TypeError("the TRMM kernels take float32 or bfloat16 operands, "
                        f"all of one dtype; got {a.dtype}, {b.dtype}")
    for t in (a, b):
        if t.device != a.device:
            raise ValueError(f"operands on {t.device} and {a.device}")
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
    ``csrc/trmm_packed.cu`` (``tri_packed``) for float32 operands,
    ``csrc/trmm_bf16.cu`` or ``csrc/trmm_packed_bf16.cu`` for bfloat16, on
    the current stream (no synchronisation) and raises if the launch is
    refused; on CPU tensors it returns :func:`trmm_plain`."""
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
    form = "trmm_packed" if variant == "tri_packed" else "trmm"
    kernel, symbol = KERNEL_OF[a.dtype][form]
    flags = (int(vec),) if form == "trmm_packed" \
        else (int(variant == "tri"), int(vec))
    grid = _build.launch_grid()
    launch = _build.launcher(kernel, _ARGTYPES[form], symbol=symbol)
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
