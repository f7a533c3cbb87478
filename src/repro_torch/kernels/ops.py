"""Public BLAS L3 API with ADSALA runtime block selection (the reference
package's ``kernels/ops.py`` for the subroutines with a Hopper kernel: gemm,
symm, syrk, syr2k and trsm).

Each op asks the :class:`~repro_torch.core.runtime.AdsalaRuntime` for the
argmin-predicted knob at the call's dims — per call, since PyTorch has no
trace time; a repeated shape is a lock-free decision-cache hit — and runs
the hand-written kernel under it.  The kernels mask ragged edge tiles, so
no operand is padded or sliced (and no tile is clamped to the matrix), and
a leading batch axis runs as one launch per kernel.

The knob spaces used by install-time calibration live here too, so the tuner
and the executor can never disagree about the candidate set.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.knobs import (HOPPER_2D_VARIANTS, HOPPER_TILES_K,
                                    HOPPER_TILES_MN, Knob, KnobSpace,
                                    hopper_2d_knob_space, hopper_knob_space)
from repro_torch.core.runtime import AdsalaRuntime, global_runtime

from . import gemm as _gemm
from . import symm as _symm
from . import syrk as _syrk
from . import trsm as _trsm

__all__ = ["gemm", "symm", "syrk", "syr2k", "trsm", "knob_space_for",
           "default_knob", "dims_of", "run_op", "DTYPE_BYTES", "HOPPER_OPS",
           "HOPPER_BACKEND"]

#: the backend name the port's kernels are tuned and served under
HOPPER_BACKEND = "hopper"

#: dims at which the baseline knob's parallelism is ranked
_BASELINE_DIMS = (4096, 4096, 4096)


@functools.lru_cache(maxsize=None)
def DTYPE_BYTES(dtype) -> int:
    """Bytes per element of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return int(dtype.itemsize)
    return int(np.dtype(dtype).itemsize)


# ---------------------------------------------------------------------------
# knob spaces (shared between calibration and execution)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def knob_space_for(op: str, *,
                   sizes: tuple[int, ...] | None = None) -> KnobSpace:
    """Candidate tiles per subroutine on the H100.

    GEMM tunes the kernel's ``(bm, bk, bn)``: ``bm, bn`` in (64, 128, 256)
    and ``bk`` in (16, 32, 64), filtered by the card's limits
    (:func:`~repro_torch.core.knobs.hopper_knob_space`).  The 2-dim
    subroutines tune ``(bm, bn)`` and the kernel variant with the
    reference's meaning of each field
    (:func:`~repro_torch.core.knobs.hopper_2d_knob_space`): symm and trsm
    an output tile, syrk and syr2k a square output tile ``bm``, the
    contraction block ``bn`` and the variants ``full``/``tri``/
    ``tri_packed``.  ``sizes`` restricts the output-tile edges to a
    subset of (64, 128, 256).  trmm has no Hopper kernel yet.
    """
    edges = tuple(sizes) if sizes else HOPPER_TILES_MN
    if op == "gemm":
        return hopper_knob_space(bms=edges, bks=HOPPER_TILES_K, bns=edges)
    if op in ("syrk", "syr2k"):
        return hopper_2d_knob_space(op, bms=edges)
    if op in HOPPER_2D_VARIANTS:
        return hopper_2d_knob_space(op, bms=edges, bns=edges)
    raise ValueError(f"no Hopper kernel for {op!r} yet; ported: "
                     f"{', '.join(HOPPER_OPS)}")


@functools.lru_cache(maxsize=None)
def default_knob(op: str) -> Knob:
    """Baseline config (paper: max threads) = maximum grid parallelism =
    smallest tiles; the first such candidate wins ties (GEMM: the smallest
    ``bk``; syrk/syr2k: the smallest contraction block, variant ``full``)."""
    space = knob_space_for(op)
    dims = _BASELINE_DIMS if op == "gemm" else _BASELINE_DIMS[:2]
    return space.candidates[int(np.argmax(space.parallelism_vec(dims)))]


def dims_of(op: str, shapes: tuple[tuple[int, ...], ...]) -> tuple[int, ...]:
    """The subroutine's free dims (paper Table I) from operand shapes.

    Leading batch axes are ignored: a stacked ``(B, m, k)`` operand yields
    the same dims as its per-item ``(m, k)`` slice, so stacked and unstacked
    calls share one decision-cache key.
    """
    if op == "gemm":
        (m, k), (_, n) = shapes[0][-2:], shapes[1][-2:]
        return (m, k, n)
    if op in ("syrk", "syr2k"):
        (n, k) = shapes[0][-2:]
        return (n, k)
    if op in ("symm", "trsm"):
        (m, _), (_, n) = shapes[0][-2:], shapes[1][-2:]
        return (m, n)
    raise ValueError(f"no Hopper kernel for {op!r} yet; ported: "
                     f"{', '.join(HOPPER_OPS)}")


def _select(op: str, dims: tuple[int, ...], dtype, knob: Optional[Knob],
            runtime: Optional[AdsalaRuntime], *, default: Knob,
            backend: str) -> Knob:
    """``knob`` when given, else the runtime's argmin-predicted knob under
    ``backend`` (``default`` where it has no tuned model)."""
    if knob is not None:
        return knob
    rt = runtime if runtime is not None else global_runtime()
    return rt.select_or_default(op, dims, DTYPE_BYTES(dtype), default,
                                backend=backend)


# ---------------------------------------------------------------------------
# public ops
# ---------------------------------------------------------------------------

def gemm(a, b, c=None, *, alpha=1.0, beta=0.0, knob=None, runtime=None):
    """``alpha * A @ B + beta * C`` under ``knob`` (the runtime's choice when
    None).  A 2-D B against a stacked A is shared across the stack."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    kb = _select("gemm", (m, k, n), a.dtype, knob, runtime,
                 default=default_knob("gemm"), backend=HOPPER_BACKEND).dict
    return _gemm.gemm(a, b, c, bm=kb["bm"], bk=kb["bk"], bn=kb["bn"],
                      alpha=alpha, beta=beta)


def symm(a, b, c=None, *, alpha=1.0, beta=0.0, knob=None, runtime=None):
    """``alpha * sym(A) @ B + beta * C``, A lower-stored."""
    m, n = a.shape[-2], b.shape[-1]
    kb = _select("symm", (m, n), a.dtype, knob, runtime,
                 default=default_knob("symm"), backend=HOPPER_BACKEND).dict
    return _symm.symm(a, b, c, bm=kb["bm"], bn=kb["bn"], alpha=alpha,
                      beta=beta)


def syrk(a, c=None, *, alpha=1.0, beta=0.0, knob=None, runtime=None):
    """``alpha * A @ A^T + beta * C``; the knob's ``bn`` is the contraction
    block."""
    n, k = a.shape[-2:]
    kb = _select("syrk", (n, k), a.dtype, knob, runtime,
                 default=default_knob("syrk"), backend=HOPPER_BACKEND).dict
    return _syrk.syrk(a, c, bm=kb["bm"], bk=kb["bn"], alpha=alpha, beta=beta,
                      variant=kb["variant"])


def syr2k(a, b, c=None, *, alpha=1.0, beta=0.0, knob=None, runtime=None):
    """``alpha * (A @ B^T + B @ A^T) + beta * C``; as :func:`syrk`."""
    n, k = a.shape[-2:]
    kb = _select("syr2k", (n, k), a.dtype, knob, runtime,
                 default=default_knob("syr2k"), backend=HOPPER_BACKEND).dict
    return _syrk.syr2k(a, b, c, bm=kb["bm"], bk=kb["bn"], alpha=alpha,
                       beta=beta, variant=kb["variant"])


def trsm(a, b, *, alpha=1.0, knob=None, runtime=None):
    """X with ``tril(A) @ X = alpha * B``."""
    m, n = a.shape[-2], b.shape[-1]
    kb = _select("trsm", (m, n), a.dtype, knob, runtime,
                 default=default_knob("trsm"), backend=HOPPER_BACKEND).dict
    return _trsm.trsm(a, b, bm=kb["bm"], bn=kb["bn"], alpha=alpha)


#: the Hopper-path executors (what the ``hopper`` backend dispatches to)
HOPPER_OPS = {"gemm": gemm, "symm": symm, "syrk": syrk, "syr2k": syr2k,
              "trsm": trsm}


def run_op(op: str, operands: tuple, *, backend: str = HOPPER_BACKEND,
           knob: Optional[Knob] = None,
           runtime: Optional[AdsalaRuntime] = None, device=None, **kw):
    """Execute ``op`` through the backend registry.

    The backend runs on its own device (the ``hopper`` backend: the CUDA
    card) unless ``device`` names another; it raises when that device is
    absent — no other backend or device stands in for it.  When no
    ``knob`` is given the ADSALA runtime selects one under the backend's
    key, or the backend's default config if it has no tuned model.

    Operands may carry a leading batch axis (``(B, m, k)`` instead of
    ``(m, k)``): the stack runs as one call via ``Backend.execute_stacked``
    under one knob decision, since all items share dims and dtype.
    Trailing operands of one-lower rank (a shared 2-D weight against
    batched activations — the model-serving linear) broadcast across the
    stack without a copy.  Returns a tensor on the backend's device.
    """
    from repro_torch.backends import resolve_backend
    be = resolve_backend(backend, device=device)
    dims = dims_of(op, tuple(tuple(x.shape) for x in operands))
    knob = _select(op, dims, operands[0].dtype, knob, runtime,
                   default=be.default_knob(op), backend=be.name)
    return be.execute_stacked(op, operands, knob, **kw)
