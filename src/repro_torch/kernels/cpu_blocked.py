"""Numpy blocked BLAS L3: the measurable "black-box BLAS" of the host CPU
(the reference package's ``kernels/cpu_blocked.py``, its functions
verbatim).

ADSALA treats the BLAS implementation as a black box and tunes its runtime
knob with *measured wall-clock* data (paper §III-A).  These are the blocked
algorithms of the card's kernels expressed in numpy, where the (bm, bk,
bn) knob has real cache-hierarchy effects: the ``cpu_blocked`` backend
(``backends/cpu.py``) runs and times them, on the host's cores, in
float32 or float64.  In the paper's MKL-vs-BLIS comparison this is the
second baseline library.
"""

from __future__ import annotations

import numpy as np

__all__ = ["run_blocked", "make_operands"]


def _gemm(a, b, c, alpha, beta, bm, bk, bn, variant):
    m, k = a.shape
    _, n = b.shape
    out = np.empty((m, n), dtype=np.promote_types(a.dtype, np.float32))
    for i0 in range(0, m, bm):
        i1 = min(i0 + bm, m)
        for j0 in range(0, n, bn):
            j1 = min(j0 + bn, n)
            acc = np.zeros((i1 - i0, j1 - j0), dtype=out.dtype)
            for l0 in range(0, k, bk):
                l1 = min(l0 + bk, k)
                acc += a[i0:i1, l0:l1] @ b[l0:l1, j0:j1]
            if beta != 0.0 and c is not None:
                acc = alpha * acc + beta * c[i0:i1, j0:j1]
            elif alpha != 1.0:
                acc = alpha * acc
            out[i0:i1, j0:j1] = acc
    return out


def _symm(a, b, c, alpha, beta, bm, bk, bn, variant):
    m = a.shape[0]
    n = b.shape[1]
    out = np.empty((m, n), dtype=np.promote_types(a.dtype, np.float32))
    for i0 in range(0, m, bm):
        i1 = min(i0 + bm, m)
        for j0 in range(0, n, bn):
            j1 = min(j0 + bn, n)
            acc = np.zeros((i1 - i0, j1 - j0), dtype=out.dtype)
            for l0 in range(0, m, bm):
                l1 = min(l0 + bm, m)
                if i0 > l0:
                    blk = a[i0:i1, l0:l1]
                elif i0 < l0:
                    blk = a[l0:l1, i0:i1].T
                else:
                    d = a[i0:i1, l0:l1]
                    blk = np.tril(d) + np.tril(d, -1).T
                acc += blk @ b[l0:l1, j0:j1]
            if beta != 0.0 and c is not None:
                acc = alpha * acc + beta * c[i0:i1, j0:j1]
            elif alpha != 1.0:
                acc = alpha * acc
            out[i0:i1, j0:j1] = acc
    return out


def _syrk(a, b, c, alpha, beta, bm, bk, bn, variant):
    # b is None for syrk, =B for syr2k.  'tri_packed' is a launch-grid
    # notion (packed vs masked-out dead cells) — on the numpy path both
    # triangle variants execute the identical packed loop below.
    n, k = a.shape
    out = np.zeros((n, n), dtype=np.promote_types(a.dtype, np.float32))
    tri = variant in ("tri", "tri_packed")
    for i0 in range(0, n, bm):
        i1 = min(i0 + bm, n)
        for j0 in range(0, n, bm):
            j1 = min(j0 + bm, n)
            if tri and j0 > i0:
                continue
            acc = np.zeros((i1 - i0, j1 - j0), dtype=out.dtype)
            for l0 in range(0, k, bn):
                l1 = min(l0 + bn, k)
                if b is None:
                    acc += a[i0:i1, l0:l1] @ a[j0:j1, l0:l1].T
                else:
                    acc += a[i0:i1, l0:l1] @ b[j0:j1, l0:l1].T
                    acc += b[i0:i1, l0:l1] @ a[j0:j1, l0:l1].T
            if beta != 0.0 and c is not None:
                cl = np.tril(c) + np.tril(c, -1).T
                acc = alpha * acc + beta * cl[i0:i1, j0:j1]
            elif alpha != 1.0:
                acc = alpha * acc
            out[i0:i1, j0:j1] = acc
    if tri:
        out = np.tril(out) + np.tril(out, -1).T
    return out


def _trmm(a, b, c, alpha, beta, bm, bk, bn, variant):
    m = a.shape[0]
    n = b.shape[1]
    out = np.zeros((m, n), dtype=np.promote_types(a.dtype, np.float32))
    tri = variant in ("tri", "tri_packed")
    for i0 in range(0, m, bm):
        i1 = min(i0 + bm, m)
        for j0 in range(0, n, bn):
            j1 = min(j0 + bn, n)
            acc = np.zeros((i1 - i0, j1 - j0), dtype=out.dtype)
            for l0 in range(0, m, bm):
                l1 = min(l0 + bm, m)
                if l0 > i0:
                    if tri:
                        continue
                    blk = np.zeros((i1 - i0, l1 - l0), dtype=out.dtype)
                elif l0 == i0:
                    blk = np.tril(a[i0:i1, l0:l1])
                else:
                    blk = a[i0:i1, l0:l1]
                acc += blk @ b[l0:l1, j0:j1]
            out[i0:i1, j0:j1] = alpha * acc
    return out


def _trsm(a, b, c, alpha, beta, bm, bk, bn, variant):
    m = a.shape[0]
    n = b.shape[1]
    x = np.zeros((m, n), dtype=np.promote_types(a.dtype, np.float32))
    for i0 in range(0, m, bm):
        i1 = min(i0 + bm, m)
        r = alpha * b[i0:i1, :].astype(x.dtype)
        for l0 in range(0, i0, bm):
            l1 = min(l0 + bm, i0)
            r = r - a[i0:i1, l0:l1] @ x[l0:l1, :]
        dinv = np.linalg.inv(np.tril(a[i0:i1, i0:i1]).astype(np.float64))
        x[i0:i1, :] = (dinv @ r.astype(np.float64)).astype(x.dtype)
    return x


_IMPLS = {"gemm": _gemm, "symm": _symm, "syrk": _syrk, "syr2k": _syrk,
          "trmm": _trmm, "trsm": _trsm}


def make_operands(op: str, dims: tuple[int, ...], dtype=np.float32,
                  seed: int = 0) -> tuple:
    """Random operands of the right shapes for ``op`` (calibration inputs)."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return rng.standard_normal(shape).astype(dtype)

    if op == "gemm":
        m, k, n = dims
        return (rand(m, k), rand(k, n))
    if op == "symm":
        m, n = dims
        return (rand(m, m), rand(m, n))
    if op == "syrk":
        n, k = dims
        return (rand(n, k),)
    if op == "syr2k":
        n, k = dims
        return (rand(n, k), rand(n, k))
    if op in ("trmm", "trsm"):
        m, n = dims
        a = rand(m, m)
        if op == "trsm":  # diagonally dominant → well-conditioned solve
            a = a + m * np.eye(m, dtype=dtype)
        return (a, rand(m, n))
    raise ValueError(op)


def run_blocked(op: str, operands: tuple, knob, *, alpha: float = 1.0,
                beta: float = 0.0) -> np.ndarray:
    """Execute the blocked numpy implementation under a block-config knob."""
    kd = knob.dict if hasattr(knob, "dict") else dict(knob)
    a = operands[0]
    b = operands[1] if len(operands) > 1 and op != "syrk" else None
    c = None
    return _IMPLS[op](a, b, c, alpha, beta, kd["bm"], kd["bk"], kd["bn"],
                      kd.get("variant", "full"))
