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

:func:`gemm` launches the kernel for CUDA tensors and records the launch
and its grid with :func:`~repro_torch.kernels.introspect.record_launch`; for
CPU tensors it computes :func:`gemm_plain`, the plain PyTorch version the
tests and the chip smoke compare the kernel with.

A grid of fewer output tiles than the card has SMs splits the contraction
(:func:`split_plan`, mirrored by the kernel): each slice sums its part into
a per-call workspace and the last slice of a tile adds them in slice order,
inside the same launch.  :func:`mainloop_params` gives the launch
parameters ``csrc/sgemm_mainloop.cuh`` derives from a tile.
"""

from __future__ import annotations

import ctypes
import itertools

import torch

from repro_torch.core.knobs import HOPPER_TILES_K, HOPPER_TILES_MN

from . import _build
from .introspect import launch_events, record_launch

__all__ = ["gemm", "gemm_plain", "TILES", "split_plan", "mainloop_params",
           "ring_stages", "vec_aligned", "HOPPER_SMS"]

#: the ``(bm, bk, bn)`` tiles ``csrc/gemm.cu`` is instantiated for
TILES = frozenset(itertools.product(HOPPER_TILES_MN, HOPPER_TILES_K,
                                    HOPPER_TILES_MN))

#: grid y and z limits of a launch (m-tiles and batch)
_MAX_GRID_YZ = 65535

#: streaming multiprocessors of an H100 SXM: a grid of fewer output tiles
#: leaves SMs idle, and split-k fills them
HOPPER_SMS = 132
#: slices of the contraction start at multiples of this, the block of
#: ``padded_ref.padded_run``, so padding k never moves a slice boundary
SPLIT_ALIGN = 128
#: shared memory of an H100 block, and what one ring of stages may take so
#: that two blocks share an SM where the tile allows
SMEM_MAX = 232448
RING_BUDGET = SMEM_MAX // 2
#: accumulators of one pass of the mainloop (256 threads x 8 x 8)
MAX_PASS = 128 * 128


def split_plan(m: int, n: int, k: int, bm: int, bn: int) -> tuple[int, int]:
    """``(slices, length)`` of the contraction for one item of an
    ``(m, k) @ (k, n)`` GEMM under the output tile ``bm x bn``
    (``csrc/gemm.cu`` mirrors it and refuses any other split).

    With ``tiles = ceil(m / bm) * ceil(n / bn)`` below :data:`HOPPER_SMS`,
    k is cut at multiples of ``length = 128 * max(2, ceil(8 * tiles /
    132))`` when it spans more than one length; else one slice of length k.
    The length depends on the tile count alone (fewer tiles, shorter
    slices), never on k or the batch, so a stack splits as its items do and
    padding k to a multiple of 128 keeps every boundary."""
    tiles = -(-m // bm) * -(-n // bn)
    length = SPLIT_ALIGN * max(2, -(-8 * tiles // HOPPER_SMS))
    if tiles >= HOPPER_SMS or k <= length:
        return 1, k
    return -(-k // length), length


def ring_stages(stage_bytes: int) -> int:
    """Stages of a ``cp.async`` ring: as many of 4, 3 as fit in
    :data:`RING_BUDGET`, else 2 (``sgemm::ring_stages``)."""
    return next((s for s in (4, 3) if s * stage_bytes <= RING_BUDGET), 2)


def mainloop_params(bm: int, bk: int, bn: int) -> dict:
    """The launch parameters ``csrc/sgemm_mainloop.cuh`` derives from the
    tile ``(bm, bk, bn)`` (symm: ``bk`` = 64): the pass (at most 128 x 128
    accumulators; a larger tile runs its passes one after the other),
    threads (128-256), the register tile, the stages of the cp.async ring
    (as many of 2-4 as fit in :data:`RING_BUDGET`, else 2) and the dynamic
    shared bytes."""
    pm, pn = (bm, bn) if bm * bn <= MAX_PASS else (min(bm, 128), min(bn, 128))
    threads = min(256, max(128, pm * pn // 64))
    stage = 4 * bk * (pm + pn)
    stages = ring_stages(stage)
    return {"pass": (pm, pn), "passes": (bm // pm) * (bn // pn),
            "threads": threads, "thread_tile": (pm * pn // threads // 8, 8),
            "stages": stages, "smem": stages * stage}


def vec_aligned(*operands: tuple[torch.Tensor, int, int]) -> bool:
    """Whether every ``(tensor, leading stride, batch stride)`` allows the
    kernels' 16-byte copies: the data pointer 16-byte aligned and both
    strides multiples of 4 floats."""
    return all(t.data_ptr() % 16 == 0 and ld % 4 == 0 and sb % 4 == 0
               for t, ld, sb in operands)

_C_LL = ctypes.c_longlong
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int,         # bm, bk, bn
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # A, B, C
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # O, ws, tickets
             ctypes.c_int, ctypes.c_int, ctypes.c_int,           # m, n, k
             ctypes.c_int,                                       # batch
             _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL,
             ctypes.c_float, ctypes.c_float, ctypes.c_int,       # alpha..
             ctypes.c_int, ctypes.c_int, ctypes.c_int,           # vec, split
             ctypes.c_void_p,                                    # stream
             ctypes.c_void_p, ctypes.c_void_p]                   # events


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
    sab, sbb = a.stride(0) if stacked else 0, b.stride(0) if b.dim() == 3 else 0
    vec = vec_aligned((a, a.stride(-2), sab), (b, b.stride(-2), sbb))
    slices, length = split_plan(m, n, k, bm, bn)
    grid = _build.launch_grid()
    with torch.cuda.device(a.device):
        # a workspace of this call's own, allocated on its stream (calls on
        # other streams, the service's workers, never share one): the
        # partial sums, then one int32 ticket per output tile, which the
        # launcher zeroes on the stream before the kernel
        ws = ws_ptr = tickets_ptr = None
        if slices > 1:
            n_ws = (batch or 1) * slices * m * n
            n_tickets = (batch or 1) * -(-m // bm) * -(-n // bn)
            ws = torch.empty(n_ws + n_tickets, dtype=torch.float32,
                             device=a.device)
            ws_ptr = ws.data_ptr()
            tickets_ptr = ws_ptr + 4 * n_ws
        stream = torch.cuda.current_stream().cuda_stream
        launch = _build.launcher("gemm", _ARGTYPES)
        events = launch_events()
        rc = launch(
            bm, bk, bn, a.data_ptr(), b.data_ptr(),
            c.data_ptr() if has_c else None, out.data_ptr(), ws_ptr,
            tickets_ptr,
            m, n, k, batch or 1, sab, a.stride(-2), sbb, b.stride(-2),
            c.stride(0) if has_c and stacked else 0,
            c.stride(-2) if has_c else 0,
            out.stride(0) if stacked else 0, out.stride(-2),
            float(alpha), float(beta), int(has_c), int(vec), slices, length,
            stream, *events, grid)
    if rc != 0:
        raise RuntimeError(f"GEMM kernel launch failed with CUDA error {rc} "
                           f"(tile {bm}x{bk}x{bn}, A {tuple(a.shape)}, "
                           f"B {tuple(b.shape)})")
    record_launch("gemm", grid)
    return out
