"""TRSM on the H100: solve ``tril(A) @ X = alpha * B`` (left, lower,
non-unit) by blocked forward substitution on the port's GEMM kernel
(``csrc/gemm.cu``, through :func:`repro_torch.kernels.gemm.gemm`).

It takes the place of the reference package's ``trsm_pallas``
(``src/repro/kernels/trsm.py``), which runs the same scheme on the Pallas
GEMM:

1. the inverses ``D_i^-1`` of the diagonal blocks, each solved against I
   with ``torch.linalg.solve_triangular``.  This is the one library call
   on the port's path: the reference computes these inverses outside
   Pallas too, with XLA's ``triangular_solve``.  They cost
   ``O(m bm^2)`` operations against the ``O(m^2 n)`` of the updates.  They
   are solved one batch item at a time, all full blocks of an item in one
   call, so that a stack and its items take the same library path and
   the stack equals its items bit for bit.
2. for each block row ``i``, two GEMM launches:
   ``R_i = alpha B_i - A[i, :i] @ X[:i]`` (the GEMM's ``beta * C``
   epilogue with ``alpha=-1``, ``beta=alpha`` and ``C = B_i``; block row 0
   has no update) and ``X_i = D_i^-1 @ R_i``, written into X's block row
   in place.  A call makes ``2 ceil(m / bm) - 1`` GEMM launches.

The knob's ``bm`` is the diagonal block and the GEMMs' output rows, its
``bn`` the GEMMs' output columns.  The reference passes ``bk = bm``, for
which the Hopper GEMM has no tile; here the GEMMs' ``bk`` is
:data:`~repro_torch.core.knobs.HOPPER_CONTRACTION_STEP` (64), the
contraction step of every kernel with a ``bm x bn`` output tile, so the
GEMM tile is ``(bm, 64, bn)``.  No operand is padded: the ragged last
diagonal block is solved at its true size, and the views ``A[i, :i]``,
``B_i`` and ``X[:i]`` have unit inner stride and go to the kernel as they
are.  A leading batch axis runs through every GEMM as one launch.

On CUDA tensors every GEMM launches the kernel; on CPU tensors the same
scheme runs on the GEMM's plain version.  :func:`trsm_plain` is the plain
PyTorch version of the whole solve.
"""

from __future__ import annotations

import torch

from repro_torch.core.knobs import HOPPER_CONTRACTION_STEP

from . import gemm as _gemm

__all__ = ["trsm", "trsm_plain", "LAUNCHES"]

#: GEMM kernel launches made by :func:`trsm` (``2 ceil(m / bm) - 1`` per
#: call on CUDA tensors)
LAUNCHES = 0


def trsm_plain(a: torch.Tensor, b: torch.Tensor, *,
               alpha: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version: one triangular solve in float32."""
    x = torch.linalg.solve_triangular(torch.tril(a.float()),
                                      alpha * b.float(), upper=False)
    return x.to(a.dtype)


def _check(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"A and B must both be 2-D or both 3-D, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    m, m2 = a.shape[-2:]
    mb, n = b.shape[-2:]
    if m != m2 or m != mb or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"A {tuple(a.shape)} must be square with B "
                         f"{tuple(b.shape)} of as many rows and items")
    if b.device != a.device:
        raise ValueError(f"operands on {b.device} and {a.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no TRSM for device {a.device}")
    return m, n


def _diag_inverses(a: torch.Tensor, bm: int):
    """``D_i^-1`` of A's diagonal blocks: the full blocks as one
    ``(..., m // bm, bm, bm)`` tensor (None if there are none) and the
    ragged last block, solved at its true size (None if m is a multiple of
    bm)."""
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


def trsm(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
         alpha: float = 1.0) -> torch.Tensor:
    """X with ``tril(A) @ X = alpha * B`` under the knob's ``bm x bn``.

    On CUDA tensors the GEMMs launch ``csrc/gemm.cu`` on the current
    stream (no synchronisation) and raise if a launch is refused."""
    global LAUNCHES
    m, n = _check(a, b)
    bk = HOPPER_CONTRACTION_STEP
    if (bm, bk, bn) not in _gemm.TILES:
        raise ValueError(f"no GEMM kernel for the TRSM tile bm={bm} bn={bn}")
    x = torch.empty(b.shape, dtype=a.dtype, device=a.device)
    if x.numel() == 0:
        return x
    full, last = _diag_inverses(a, bm)
    before = _gemm.LAUNCHES
    for i in range(-(-m // bm)):
        lo, hi = i * bm, min((i + 1) * bm, m)
        dinv = full[..., i, :, :] if hi - lo == bm else last
        if i == 0:
            r, scale = b[..., :hi, :], alpha
        else:
            r = _gemm.gemm(a[..., lo:hi, :lo], x[..., :lo, :],
                           b[..., lo:hi, :], bm=bm, bk=bk, bn=bn,
                           alpha=-1.0, beta=alpha)
            scale = 1.0
        _gemm.gemm(dinv, r, bm=bm, bk=bk, bn=bn, alpha=scale,
                   out=x[..., lo:hi, :])
    LAUNCHES += _gemm.LAUNCHES - before
    return x
