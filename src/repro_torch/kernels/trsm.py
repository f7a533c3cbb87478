"""TRSM on the H100: solve ``tril(A) @ X = alpha * B`` (left, lower,
non-unit) by blocked forward substitution, with two CUDA C++ kernels written
for Hopper in one source a dtype, so a call makes two launches whatever m
and the batch: ``csrc/trsm.cu`` for float32 operands, ``csrc/trsm_bf16.cu``
(the tensor cores) for bfloat16.

1. ``trsm_inv`` (:func:`diag_inverses`): the inverses ``D_i^-1`` of the
   ``bm x bm`` diagonal blocks of tril(A), the ragged last block at its
   true size, of every item, each column solved against ``e_j`` by forward
   substitution, into a workspace ``(..., ceil(m / bm), bm, bm)``;
2. ``trsm`` (:func:`substitute`): one block per column strip ``bn`` of X
   and item walks the block rows in order, each a contraction on the f32
   mainloop (``csrc/sgemm_mainloop.cuh``)
   ``R_i = alpha B_i - A[i, :i] @ X[:i]`` (block row 0: ``R_0 = B_0``,
   alpha moving to the next step) and then ``X_i = D_i^-1 @ R_i``.

The bf16 kernels, ``trsm_inv_bf16`` and ``trsm_bf16``, run the same two
steps with the reference's rounding points: each inverse entry computed in
float32 as ``trsm_inv`` computes it and rounded once, and per block row
``R_i = bf16(float(bf16(alpha B_i)) - float(bf16(A[i, :i] @ X[:i])))``
(block row 0 included, its contraction empty) and ``X_i = bf16(D_i^-1 @
R_i)``, every product summed in float32 on the bf16 GEMM's wgmma + TMA
mainloop (``csrc/bf16_wgmma_mainloop.cuh``).  The substitution runs every
step of a strip's block rows as one sequence through one ring
(:func:`step_plan`), keeps ``R_i`` in shared memory for the products
that read it next, and copies rows of X by TMA only once the epilogue that
stored them has ended.  X is bf16 between block rows, as in the
reference, whose every intermediate is in A's dtype.  alpha multiplies in
float32 (the reference's bf16 product rounds alpha to bf16 first: the two
agree where alpha is a bf16 value).

It takes the place of the reference package's ``trsm_pallas``
(``src/repro/kernels/trsm.py``), which runs the same scheme at trace time:
the inverses from XLA's ``triangular_solve`` and two Pallas GEMMs per block
row.  The knob's ``bm`` is the diagonal block and the rows of a step, its
``bn`` the column strip; the contraction step is
:data:`~repro_torch.core.knobs.HOPPER_CONTRACTION_STEP` (64).  No operand
is padded and a leading batch axis is the grid's z.  When A, B and their
strides are 16-byte aligned (and n a multiple of 4 float32 or 8 bf16
elements, for X) the kernels move 16 bytes a copy, else one element, with
the same bits.

On CUDA tensors :func:`trsm` launches both kernels of the operands' dtype
on the current stream and records each launch; nothing else runs on the
card (no library call and no loop on the host).  On CPU tensors it runs
the plain versions of the same scheme: :func:`diag_inverses_plain`
(``torch.linalg.solve_triangular`` against I, in float32 and rounded once
for bf16) and :func:`substitute_plain` (the two products of each block row
on the GEMM's plain version).  :func:`trsm_plain` is the plain version of
the whole solve.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.knobs import (HOPPER_CONTRACTION_STEP,
                                    hopper_2d_knob_space)

from . import _build
from . import gemm as _gemm
from .introspect import launch_events, record_launch

__all__ = ["trsm", "trsm_plain", "diag_inverses", "diag_inverses_plain",
           "substitute", "substitute_plain", "inverse_blocks", "trsm_params",
           "step_plan", "Step", "TILES", "INV_COLS", "INV_ROWS", "KERNEL_OF"]

#: the ``(bm, bn)`` tiles ``csrc/trsm.cu`` is instantiated for
TILES = frozenset((k["bm"], k["bn"]) for k in hopper_2d_knob_space("trsm"))
#: the inverse kernel's columns per block (its threads) and rows per group
INV_COLS, INV_ROWS = 64, 8
#: the operand dtypes the TRSM kernels take: dtype -> {step: (kernel, C
#: launcher)}, the step ``trsm_inv`` (the inverses) or ``trsm`` (the
#: substitution); both steps of a dtype are built from one source
KERNEL_OF = {torch.float32: {"trsm_inv": ("trsm_inv", "repro_trsm_inv_f32"),
                             "trsm": ("trsm", "repro_trsm_f32")},
             torch.bfloat16: {"trsm_inv": ("trsm_inv_bf16",
                                           "repro_trsm_inv_bf16"),
                              "trsm": ("trsm_bf16", "repro_trsm_bf16")}}
_SOURCE_OF = {torch.float32: "trsm", torch.bfloat16: "trsm_bf16"}

#: grid z limit of a launch (the batch)
_MAX_GRID_Z = 65535

_C_LL = ctypes.c_longlong
_INV_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # bm, A, inv
                 ctypes.c_int, ctypes.c_int, _C_LL, _C_LL,      # m, batch, sA
                 ctypes.c_void_p,                               # stream
                 ctypes.c_void_p, ctypes.c_void_p]              # events
_ARGTYPES = [ctypes.c_int, ctypes.c_int,                        # bm, bn
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # A, B, inv
             ctypes.c_void_p,                                   # X
             ctypes.c_int, ctypes.c_int, ctypes.c_int,          # m, n, batch
             _C_LL, _C_LL, _C_LL, _C_LL, _C_LL, _C_LL,          # strides
             ctypes.c_float, ctypes.c_int,                      # alpha, vec
             ctypes.c_void_p,                                   # stream
             ctypes.c_void_p, ctypes.c_void_p]                  # events


def trsm_params(bm: int, bn: int, dtype: torch.dtype = torch.float32) -> dict:
    """The launch parameters ``csrc/trsm.cu`` (float32) or
    ``csrc/trsm_bf16.cu`` (bfloat16) derives from the tile: the
    substitution's (the mainloop's of ``dtype`` at ``(bm, 64, bn)``,
    :func:`~repro_torch.kernels.gemm.mainloop_params`), the inverse
    kernel's threads and dynamic shared bytes (its x columns and two
    groups' rows of D, float32 for both dtypes), and the workspace bytes of
    one diagonal block's inverse, in ``dtype`` (a call holds ``batch *
    ceil(m / bm)`` of them).

    bfloat16: the wgmma loop's tile with the substitution's own shared
    region (``region``: ``bm x bn`` bf16 values, which receives B_i's copy
    and then holds R_i), blocks an SM (the grid is a block a strip and
    item, so at most 2, and 1 where 2 would leave the ring fewer than 3
    stages beside the region) and ring (2 to 16 stages, as many as fit ``1
    / blocks`` of the SM's shared memory less 4 KB and the region), and the
    dynamic shared bytes (1024 to align, the region, the ring and 28 bytes
    a stage: its barrier, release count and pending step)."""
    if dtype not in KERNEL_OF:
        raise TypeError(f"no TRSM kernels for {dtype}")
    step = HOPPER_CONTRACTION_STEP
    p = _gemm.mainloop_params(bm, step, bn, dtype)
    if dtype == torch.bfloat16:
        pm, pn = p["pass"]
        stage = 2 * step * (pm + pn)
        region = 2 * bm * pn

        def budget(blocks):
            return _gemm.SMEM_SM // blocks - 4 * _gemm.SWIZZLE_REPEAT \
                - region

        blocks = 2 if min(p["blocks"], 2) == 2 and budget(2) >= 3 * stage \
            else 1
        stages = max(2, min(_gemm.WGMMA_MAX_STAGES, budget(blocks) // stage))
        p.update(blocks=blocks, stages=stages, region=region,
                 smem=_gemm.SWIZZLE_REPEAT + region + stages * (stage + 28))
    return {**p, "inv_threads": INV_COLS,
            "inv_smem": 4 * bm * (INV_COLS + 2 * INV_ROWS),
            "block_workspace": dtype.itemsize * bm * bm}


class Step(NamedTuple):
    """A step of the bf16 substitution: block row ``i``, ``step`` 0 (A's
    block row against X) or 1 (``D_i^-1`` against ``R_i``), the first row
    ``prow`` of its pass in the block row, its first contraction index
    ``k0``; where its A (``"A"`` or ``"inv"``) and its B (``"x_tma"``: X's
    rows by TMA, or ``"r_region"``: R_i's shared region) come from; and
    ``epoch``, the end of the step after which its TMA copies may be
    issued: ``2 i + 1`` after step 0 of block row i, ``2 i + 2`` after its
    step 1 (0: any time)."""
    i: int
    step: int
    prow: int
    k0: int
    a: str
    b: str
    epoch: int


def step_plan(m: int, bm: int, bn: int) -> list[Step]:
    """The steps of a block of ``csrc/trsm_bf16.cu``'s substitution under
    the tile ``bm x bn``, in the order they run through its ring: the
    mirror of ``TrsmSteps`` and ``TrsmProducer``.

    Block rows in order; per block row ``i`` (``r = min(bm, m - i bm)``
    rows), step 0's passes of ``min(bm, 128)`` rows that start below r,
    each over the ``lo / 64`` steps of ``A[i, :lo] @ X[:lo]``, then step
    1's passes, the pass at ``prow`` over ``ceil(min(prow + pass rows, r) /
    64)`` steps, passes top-down.  Step 0 reads X's rows by TMA, step 1
    ``R_i`` from its shared region.  A copy of X's rows of block row q
    waits for the fence after their stores, at the end of q's step 1."""
    if (bm, bn) not in TILES:
        raise ValueError(f"no TRSM kernel for tile bm={bm} bn={bn}")
    step, pm = HOPPER_CONTRACTION_STEP, min(bm, 128)
    plan = []
    for i in range(-(-m // bm)):
        lo, r = i * bm, min(bm, m - i * bm)
        for prow in range(0, r, pm):
            plan += [Step(i, 0, prow, k0, "A", "x_tma", 2 * (k0 // bm) + 2)
                     for k0 in range(0, lo, step)]
        for prow in range(0, r, pm):
            plan += [Step(i, 1, prow, k0, "inv", "r_region", 0)
                     for k0 in range(0, min(prow + pm, r), step)]
    return plan


def trsm_plain(a: torch.Tensor, b: torch.Tensor, *, alpha: float = 1.0,
               bm: int | None = None) -> torch.Tensor:
    """The plain PyTorch version.  float32: one triangular solve in
    float32 (``bm`` unused).  bfloat16: the blocked scheme under the
    diagonal block ``bm`` with the reference's rounding points,
    :func:`diag_inverses_plain` and :func:`substitute_plain` on the GEMM's
    plain version, on whatever device holds the operands (no kernel is
    launched); one float32 solve rounded once is not that scheme, and lies
    further from the reference than one bf16 ulp of the largest output."""
    if a.dtype != torch.bfloat16:
        x = torch.linalg.solve_triangular(torch.tril(a.float()),
                                          alpha * b.float(), upper=False)
        return x.to(a.dtype)
    if bm is None:
        raise ValueError("the bf16 TRSM's plain version runs the blocked "
                         "scheme: give its diagonal block bm")
    _check(a, b)
    x = torch.empty(b.shape, dtype=a.dtype, device=a.device)
    if x.numel():
        full, last = diag_inverses_plain(a, bm)
        substitute_plain(a, b, x, full, last, bm=bm,
                         bn=HOPPER_CONTRACTION_STEP, alpha=alpha)
    return x


def _check(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"A and B must both be 2-D or both 3-D, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    m, m2 = a.shape[-2:]
    mb, n = b.shape[-2:]
    if m != m2 or m != mb or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"A {tuple(a.shape)} must be square with B "
                         f"{tuple(b.shape)} of as many rows and items")
    if a.dtype not in KERNEL_OF or b.dtype != a.dtype:
        raise TypeError("the TRSM kernels take float32 or bfloat16 operands, "
                        f"all of one dtype; got {a.dtype}, {b.dtype}")
    for t in (a, b):
        if t.device != a.device:
            raise ValueError(f"operands on {t.device} and {a.device}")
        if t.numel() and t.stride(-1) != 1:
            raise ValueError("the TRSM kernels need rows with unit inner "
                             f"stride, got strides {t.stride()}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no TRSM for device {a.device}")
    if a.dim() == 3 and a.shape[0] > _MAX_GRID_Z:
        raise ValueError(f"batch {a.shape[0]} beyond one launch's grid")
    return m, n


def _check_bm(bm: int) -> None:
    if bm not in {t[0] for t in TILES}:
        raise ValueError(f"no TRSM inverse kernel for bm={bm}")


def diag_inverses_plain(a: torch.Tensor, bm: int):
    """``D_i^-1`` of A's diagonal blocks: the full blocks as one
    ``(..., m // bm, bm, bm)`` tensor (None if there are none) and the
    ragged last block, solved at its true size (None if m is a multiple of
    bm).  The plain version of :func:`diag_inverses`.  A bf16 A is solved
    in float32 and each entry rounded once to bf16, as its kernel rounds
    (``solve_triangular`` takes no bf16 on the CPU)."""
    if a.dtype == torch.bfloat16:
        return tuple(None if d is None else d.to(a.dtype)
                     for d in diag_inverses_plain(a.float(), bm))
    lead, m = a.shape[:-2], a.shape[-1]
    nfull, rag = divmod(m, bm)
    full = a.new_empty((*lead, nfull, bm, bm)) if nfull else None
    last = a.new_empty((*lead, rag, rag)) if rag else None
    eye = torch.eye(bm, dtype=a.dtype, device=a.device)
    items = a.unbind(0) if lead else (a,)
    for idx, item in enumerate(items):
        if nfull:
            span = item[:nfull * bm, :nfull * bm]
            blocks = span.unflatten(0, (nfull, bm)).unflatten(-1, (nfull, bm))
            diag = blocks.diagonal(dim1=0, dim2=2).movedim(-1, 0)
            torch.linalg.solve_triangular(
                diag.tril(), eye, upper=False,
                out=full[idx] if lead else full)
        if rag:
            torch.linalg.solve_triangular(
                item[nfull * bm:, nfull * bm:].tril(), eye[:rag, :rag],
                upper=False, out=last[idx] if lead else last)
    return full, last


def inverse_blocks(inv: torch.Tensor, m: int, bm: int):
    """The workspace of :func:`diag_inverses` as :func:`diag_inverses_plain`
    returns it: ``(full, last)``, views."""
    nfull, rag = divmod(m, bm)
    return (inv[..., :nfull, :, :] if nfull else None,
            inv[..., nfull, :rag, :rag] if rag else None)


def _plain_gemm(a, b, c=None, *, bm, bk, bn, alpha=1.0, beta=0.0, out=None):
    """The GEMM's plain version: through the GEMM's wrapper on CPU tensors,
    where that is what the wrapper runs, and called by name on CUDA ones, so
    the plain scheme never launches a kernel."""
    if a.device.type == "cpu":
        return _gemm.gemm(a, b, c, bm=bm, bk=bk, bn=bn, alpha=alpha,
                          beta=beta, out=out)
    res = _gemm.gemm_plain(a, b, c, alpha=alpha, beta=beta)
    return res if out is None else out.copy_(res)


def substitute_plain(a, b, x, full, last, *, bm: int, bn: int,
                     alpha: float) -> None:
    """The block rows of the forward substitution from the inverses
    ``full``, ``last`` (:func:`diag_inverses_plain`), into ``x``: the plain
    version of :func:`substitute`, two products per block row (one in
    block row 0) on the GEMM's plain version.  On bf16 operands each block
    row rounds where the reference's does: ``bf16(alpha B_i)``, the update
    ``bf16(A[i, :i] @ X[:i])``, their difference, and ``bf16(D_i^-1 @
    R_i)``."""
    m, bk = a.shape[-1], HOPPER_CONTRACTION_STEP
    bf16 = a.dtype == torch.bfloat16
    for i in range(-(-m // bm)):
        lo, hi = i * bm, min((i + 1) * bm, m)
        dinv = full[..., i, :, :] if hi - lo == bm else last
        if bf16:
            r = (alpha * b[..., lo:hi, :].float()).to(a.dtype)
            if i > 0:
                upd = _plain_gemm(a[..., lo:hi, :lo], x[..., :lo, :], bm=bm,
                                  bk=bk, bn=bn)
                r = (r.float() - upd.float()).to(a.dtype)
            _plain_gemm(dinv, r, bm=bm, bk=bk, bn=bn, out=x[..., lo:hi, :])
            continue
        if i == 0:
            r, scale = b[..., :hi, :], alpha
        else:
            r = _plain_gemm(a[..., lo:hi, :lo], x[..., :lo, :],
                            b[..., lo:hi, :], bm=bm, bk=bk, bn=bn,
                            alpha=-1.0, beta=alpha)
            scale = 1.0
        _plain_gemm(dinv, r, bm=bm, bk=bk, bn=bn, alpha=scale,
                    out=x[..., lo:hi, :])


def diag_inverses(a: torch.Tensor, *, bm: int) -> torch.Tensor:
    """The inverses of tril(A)'s ``bm x bm`` diagonal blocks as a new
    ``(..., ceil(m / bm), bm, bm)`` tensor: block i's in its top-left
    corner at the block's true size, zeros above its diagonal and past that
    size.

    On CUDA tensors this launches ``csrc/trsm.cu``'s ``trsm_inv`` (bf16:
    ``csrc/trsm_bf16.cu``'s ``trsm_inv_bf16``, a tensor of A's dtype) on
    the current stream; on CPU tensors it packs
    :func:`diag_inverses_plain`."""
    _check(a, a)
    _check_bm(bm)
    m = a.shape[-1]
    inv = torch.zeros if a.device.type == "cpu" else torch.empty
    out = inv((*a.shape[:-2], -(-m // bm), bm, bm), dtype=a.dtype,
              device=a.device)
    if a.device.type == "cpu":
        full, last = diag_inverses_plain(a, bm)
        mine_full, mine_last = inverse_blocks(out, m, bm)
        if full is not None:
            mine_full.copy_(full)
        if last is not None:
            mine_last.copy_(last)
        return out
    if out.numel():
        with torch.cuda.device(a.device):
            _launch_inv(a, out, bm,
                        torch.cuda.current_stream().cuda_stream)
    return out


def substitute(a: torch.Tensor, b: torch.Tensor, inv: torch.Tensor, *,
               bm: int, bn: int, alpha: float = 1.0) -> torch.Tensor:
    """X with ``tril(A) @ X = alpha * B`` from the inverses ``inv`` of
    :func:`diag_inverses` under the same ``bm``, as a new tensor.

    On CUDA tensors this launches ``csrc/trsm.cu``'s ``trsm`` (bf16:
    ``csrc/trsm_bf16.cu``'s ``trsm_bf16``) on the current stream; on CPU
    tensors it runs :func:`substitute_plain`."""
    m, n = _check(a, b)
    if (bm, bn) not in TILES:
        raise ValueError(f"no TRSM kernel for tile bm={bm} bn={bn}")
    want = (*a.shape[:-2], -(-m // bm), bm, bm)
    if tuple(inv.shape) != want or inv.dtype != a.dtype \
            or inv.device != a.device or not inv.is_contiguous():
        raise ValueError(f"inverses {tuple(inv.shape)} {inv.dtype} on "
                         f"{inv.device}, need a contiguous {want}")
    x = torch.empty(b.shape, dtype=a.dtype, device=a.device)
    if x.numel() == 0:
        return x
    if a.device.type == "cpu":
        substitute_plain(a, b, x, *inverse_blocks(inv, m, bm), bm=bm, bn=bn,
                         alpha=alpha)
        return x
    with torch.cuda.device(a.device):
        _launch(a, b, inv, x, bm=bm, bn=bn, alpha=alpha,
                stream=torch.cuda.current_stream().cuda_stream)
    return x


def trsm(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
         alpha: float = 1.0) -> torch.Tensor:
    """X with ``tril(A) @ X = alpha * B`` under the knob's ``bm x bn``.

    On CUDA tensors this launches ``trsm_inv`` and then ``trsm`` (bf16:
    ``trsm_inv_bf16`` and ``trsm_bf16``) on the current stream (no
    synchronisation) and raises if a launch is refused; on CPU tensors it
    runs :func:`diag_inverses_plain` and :func:`substitute_plain`."""
    m, _n = _check(a, b)
    if (bm, bn) not in TILES:
        raise ValueError(f"no TRSM kernel for tile bm={bm} bn={bn}")
    x = torch.empty(b.shape, dtype=a.dtype, device=a.device)
    if x.numel() == 0:
        return x
    if a.device.type == "cpu":
        full, last = diag_inverses_plain(a, bm)
        substitute_plain(a, b, x, full, last, bm=bm, bn=bn, alpha=alpha)
        return x
    inv = torch.empty((*a.shape[:-2], -(-m // bm), bm, bm), dtype=a.dtype,
                      device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch_inv(a, inv, bm, stream)
        _launch(a, b, inv, x, bm=bm, bn=bn, alpha=alpha, stream=stream)
    return x


def _raise(kernel: str, rc: int, what: str) -> None:
    raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {rc} "
                       f"({what})")


def _launch_inv(a, inv, bm, stream) -> None:
    """Launch the inverse kernel of A's dtype on checked A into the
    contiguous ``inv`` and record the launch."""
    stacked = a.dim() == 3
    kernel, symbol = KERNEL_OF[a.dtype]["trsm_inv"]
    grid = _build.launch_grid()
    launch = _build.launcher(kernel, _INV_ARGTYPES,
                             source=_SOURCE_OF[a.dtype], symbol=symbol)
    events = launch_events()
    rc = launch(
        bm, a.data_ptr(), inv.data_ptr(), a.shape[-1],
        a.shape[0] if stacked else 1, a.stride(0) if stacked else 0,
        a.stride(-2), stream, *events, grid)
    if rc != 0:
        _raise(kernel, rc, f"bm {bm}, A {tuple(a.shape)}")
    record_launch(kernel, grid)


def _launch(a, b, inv, x, *, bm, bn, alpha, stream) -> None:
    """Launch the substitution kernel of A's dtype on checked operands, the
    inverses ``inv`` and the new ``x``, and record the launch."""
    stacked = a.dim() == 3
    sab, sbb, sxb = (a.stride(0), b.stride(0), x.stride(0)) if stacked \
        else (0, 0, 0)
    vec = _gemm.vec_aligned((a, a.stride(-2), sab), (b, b.stride(-2), sbb),
                            (x, x.stride(-2), sxb))
    kernel, symbol = KERNEL_OF[a.dtype]["trsm"]
    grid = _build.launch_grid()
    launch = _build.launcher(kernel, _ARGTYPES, source=_SOURCE_OF[a.dtype],
                             symbol=symbol)
    events = launch_events()
    rc = launch(
        bm, bn, a.data_ptr(), b.data_ptr(), inv.data_ptr(), x.data_ptr(),
        a.shape[-1], b.shape[-1], a.shape[0] if stacked else 1, sab,
        a.stride(-2), sbb, b.stride(-2), sxb, x.stride(-2), float(alpha),
        int(vec), stream, *events, grid)
    if rc != 0:
        _raise(kernel, rc, f"tile {bm}x{bn}, A {tuple(a.shape)}, "
               f"B {tuple(b.shape)}")
    record_launch(kernel, grid)
