"""The pad → run → slice path, kept only as a verification oracle (the
reference package's ``kernels/padded_ref.py``).

The port's kernels mask their ragged edge tiles instead of padding the
operands.  The masked zeros take exactly the places that zero padding would
fill, so a kernel run on ragged operands must equal the same kernel run on
operands zero-padded to tile multiples, sliced back, bit for bit.
:func:`padded_run` is that second run; ``chip_smoke.py`` and the tests hold
``run_op`` against it.  Never used on any execution path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.knobs import HOPPER_CONTRACTION_STEP, Knob

from . import ops

__all__ = ["padded_run", "block_knob"]


def _rup(v: int, b: int) -> int:
    return -(-v // b) * b


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(x, (0, cols - x.shape[-1], 0, rows - x.shape[-2]))


def block_knob(op: str, block: int = 128, variant: str = "full") -> Knob:
    """The knob with output tile ``block`` (and, for the GEMM, the
    contraction step :data:`HOPPER_CONTRACTION_STEP`; for syrk/syr2k the
    contraction block 64) under which :func:`padded_run` runs ``op``; the
    masked run it is held against takes the same knob."""
    if op == "gemm":
        kd = {"bm": block, "bk": HOPPER_CONTRACTION_STEP, "bn": block,
              "variant": "full"}
    elif op in ("syrk", "syr2k"):
        kd = {"bm": block, "bk": block, "bn": 64, "variant": variant}
    else:
        kd = {"bm": block, "bk": block, "bn": block, "variant": variant}
    return Knob(tuple(sorted(kd.items())))


def padded_run(op: str, operands: tuple, *, variant: str = "full",
               block: int = 128) -> torch.Tensor:
    """Run ``op`` the padded way: zero-pad every operand to ``block``
    multiples (trsm: the identity on the padded diagonal, so the padded
    system stays solvable), run the same kernel under
    :func:`block_knob`, slice the result back."""
    B = block
    knob = block_knob(op, block, variant)
    run = ops.HOPPER_OPS[op]
    if op == "gemm":
        a, b = operands
        (m, k), n = a.shape[-2:], b.shape[-1]
        M, K, N = _rup(m, B), _rup(k, B), _rup(n, B)
        return run(_pad(a, M, K), _pad(b, K, N), knob=knob)[..., :m, :n]
    if op in ("symm", "trmm", "trsm"):
        a, b = operands
        m, n = a.shape[-1], b.shape[-1]
        M, N = _rup(m, B), _rup(n, B)
        ap = _pad(a, M, M)
        if op == "trsm" and M > m:
            eye = torch.zeros(M, dtype=a.dtype, device=a.device)
            eye[m:] = 1.0
            ap = ap + torch.diag(eye)
        return run(ap, _pad(b, M, N), knob=knob)[..., :m, :n]
    if op in ("syrk", "syr2k"):
        n, k = operands[0].shape[-2:]
        N, K = _rup(n, B), _rup(k, B)
        padded = [_pad(x, N, K) for x in operands]
        return run(*padded, knob=knob)[..., :n, :n]
    raise ValueError(f"no padded run for {op!r}")
