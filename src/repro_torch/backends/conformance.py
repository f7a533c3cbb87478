"""Cross-backend numeric conformance harness (the reference package's
``backends/conformance.py``, for the port's backends).

One implementation of the check "does backend X compute op Y correctly",
shared by the CPU tests and ``chip_smoke.py``.  The oracle is plain numpy in
float64, independent of every backend (the ``ref`` backend included).  The
operands are drawn by the backend itself (:meth:`Backend.make_operands`, on
its device) and copied to the host for the oracle.  Beyond the reference's
harness a check can add ``alpha``/``beta`` with a C operand, run under a
given knob, and take its tolerance per call: the card holds float32 to
``2e-5`` (``chip_smoke.py``), tighter than the reference's 5e-4.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.knobs import Knob

from .registry import available_backends, get_backend

__all__ = ["DEFAULT_DIMS", "RAGGED_DIMS", "TOLERANCES", "ConformanceResult",
           "check_backend_op", "error_scale", "oracle", "run_conformance",
           "tolerance_for"]

#: tiny, deliberately non-block-aligned dims
DEFAULT_DIMS = {"gemm": (48, 32, 40), "symm": (48, 40), "syrk": (48, 32),
                "syr2k": (48, 32), "trmm": (48, 40), "trsm": (48, 40)}

#: ragged dims spanning a ragged last tile behind full tiles (129, 257), a
#: degenerate single-row problem (1, ...), and an off-multiple square (300)
RAGGED_DIMS = {
    "gemm": ((129, 65, 257), (1, 300, 384), (300, 300, 300)),
    "symm": ((129, 257), (1, 384), (300, 300)),
    "syrk": ((129, 257), (1, 384), (300, 300)),
    "syr2k": ((129, 257), (1, 384), (300, 300)),
    "trmm": ((129, 257), (1, 384), (300, 300)),
    "trsm": ((129, 257), (1, 384), (300, 300)),
}

#: max relative error vs the f64 numpy oracle, keyed by operand dtype bytes
TOLERANCES = {4: 5e-4, 8: 1e-10}

#: the subroutines whose result adds ``beta * C``
_WITH_C = ("gemm", "symm", "syrk", "syr2k")


def tolerance_for(dtype) -> float:
    if isinstance(dtype, torch.dtype):
        return TOLERANCES[dtype.itemsize]
    return TOLERANCES[int(np.dtype(dtype).itemsize)]


def _sym_lower(a: np.ndarray) -> np.ndarray:
    return np.tril(a) + np.swapaxes(np.tril(a, -1), -1, -2)


def oracle(op: str, operands: tuple, *, alpha: float = 1.0,
           beta: float = 0.0, variant: str = "full") -> np.ndarray:
    """BLAS semantics (paper Table I) in plain numpy at float64, over a
    leading batch axis.  A C operand, when ``operands`` carries one after
    the inputs, adds ``beta * C``: as given for syrk/syr2k ``full``, as a
    lower-stored symmetric matrix for ``tri``/``tri_packed`` (the
    reference's Pallas kernels)."""
    xs = [np.asarray(x, np.float64) for x in operands]
    t = lambda x: np.swapaxes(x, -1, -2)       # noqa: E731
    n_in = {"gemm": 2, "symm": 2, "syrk": 1, "syr2k": 2, "trmm": 2,
            "trsm": 2}[op]
    ins, rest = xs[:n_in], xs[n_in:]
    if op == "gemm":
        out = ins[0] @ ins[1]
    elif op == "symm":
        out = _sym_lower(ins[0]) @ ins[1]
    elif op == "syrk":
        out = ins[0] @ t(ins[0])
    elif op == "syr2k":
        out = ins[0] @ t(ins[1]) + ins[1] @ t(ins[0])
    elif op == "trmm":
        out = np.tril(ins[0]) @ ins[1]
    elif op == "trsm":
        return np.linalg.solve(np.tril(ins[0]), alpha * ins[1])
    else:
        raise ValueError(op)
    out = alpha * out
    if rest and beta != 0.0:
        c = rest[0]
        if op in ("syrk", "syr2k") and variant != "full":
            c = _sym_lower(c)
        out = out + beta * c
    return out


def error_scale(op: str, operands: tuple, want: np.ndarray, *,
                alpha: float = 1.0) -> float:
    """What the relative error is taken against: the largest output, or,
    for a product whose outputs all cancel to near zero (a 1 x 1 syr2k is
    one dot product), the magnitude ``||x|| ||y|| / sqrt(k)`` that a dot
    product of the operands' largest row and column has for random signs
    (twice that for syr2k's two products).  Over a product with more than
    a few outputs the largest output lies above that floor, so the floor
    changes nothing there; trsm takes the largest output alone."""
    top = float(np.max(np.abs(want))) if want.size else 0.0
    if op == "trsm":
        return top
    xs = [np.asarray(x, np.float64) for x in operands]
    t = lambda x: np.swapaxes(x, -1, -2)       # noqa: E731
    if op == "gemm":
        left, right = xs[0], xs[1]
    elif op == "symm":
        left, right = _sym_lower(xs[0]), xs[1]
    elif op == "trmm":
        left, right = np.tril(xs[0]), xs[1]
    elif op == "syrk":
        left, right = xs[0], t(xs[0])
    else:
        left, right = xs[0], t(xs[1])
    k = left.shape[-1]
    if k == 0:
        return top
    norm = np.sqrt((left ** 2).sum(-1)).max() * \
        np.sqrt((right ** 2).sum(-2)).max()
    terms = 2 if op == "syr2k" else 1
    return max(top, abs(alpha) * terms * float(norm) / np.sqrt(k))


@dataclasses.dataclass
class ConformanceResult:
    backend: str
    op: str
    dtype: str
    dims: tuple[int, ...]
    stacked: int            # 0 = single 2-D call, >0 = stack width
    knob: str = ""
    with_c: bool = False
    rel_err: float = float("nan")
    ok: bool = False
    skipped: str | None = None      # reason, when not executed
    error: str | None = None        # exception repr, when execution raised

    def line(self) -> str:
        tag = f"{self.backend}:{self.op}:{self.dtype}" + \
            (f":x{self.stacked}" if self.stacked else "") + \
            (":c" if self.with_c else "")
        if self.skipped:
            return f"{tag} SKIP ({self.skipped})"
        if self.error:
            return f"{tag} ERROR {self.error}"
        return (f"{tag} dims={self.dims} {self.knob} "
                f"relerr={self.rel_err:.2e} "
                f"{'ok' if self.ok else 'MISMATCH'}")


def _operands(be, op, dims, dtype, seed, with_c):
    xs = be.make_operands(op, dims, dtype, seed=seed)
    if with_c:
        rows = dims[0]
        cols = dims[-1] if op in ("gemm", "symm") else dims[0]
        gen = torch.Generator(device=be.device).manual_seed(seed + 7919)
        xs = xs + (torch.randn((rows, cols), generator=gen, device=be.device,
                               dtype=dtype),)
    return xs


def check_backend_op(backend: str, op: str, dtype=torch.float32, *,
                     dims: tuple[int, ...] | None = None,
                     tol: float | None = None, stacked: int = 0,
                     seed: int = 0, knob: Knob | None = None,
                     device=None, alpha: float = 1.0, beta: float = 0.0,
                     with_c: bool = False) -> ConformanceResult:
    """Run one (backend, op, dtype) instance against the numpy oracle.

    ``stacked > 0`` runs a stack of that width (each item with its own
    operands) as one call through ``Backend.execute_stacked``.  ``knob``
    defaults to the backend's default knob; ``device`` binds the backend
    to another device (``"cpu"`` for the plain versions).  ``with_c``
    adds a C operand (gemm, symm, syrk, syr2k) under ``alpha``/``beta``;
    trsm takes ``alpha`` alone.  Operands are drawn on the backend's device
    and copied to the host for the oracle.
    """
    be = get_backend(backend)
    if device is not None:
        be = be.on(device)
    dims = tuple(dims) if dims is not None else DEFAULT_DIMS[op]
    dtype = dtype if isinstance(dtype, torch.dtype) \
        else getattr(torch, np.dtype(dtype).name)
    with_c = with_c and op in _WITH_C
    knob = knob if knob is not None else be.default_knob(op)
    res = ConformanceResult(backend=be.name, op=op,
                            dtype=str(dtype).replace("torch.", ""),
                            dims=dims, stacked=stacked, knob=repr(knob),
                            with_c=with_c)
    if not be.is_available():
        res.skipped = f"{be.device} unavailable on host"
        return res
    if not be.supports_dtype(dtype):
        res.skipped = f"{res.dtype} unsupported"
        return res
    tol = tol if tol is not None else tolerance_for(dtype)
    kw = {"alpha": alpha}
    if op in _WITH_C:
        kw["beta"] = beta
    variant = knob.dict.get("variant", "full")
    try:
        if stacked:
            items = [_operands(be, op, dims, dtype, seed + i, with_c)
                     for i in range(stacked)]
            operands = tuple(torch.stack([it[j] for it in items])
                             for j in range(len(items[0])))
            got = be.execute_stacked(op, operands, knob, **kw)
        else:
            operands = _operands(be, op, dims, dtype, seed, with_c)
            got = be.execute(op, operands, knob, **kw)
        got = got.double().cpu().numpy()
    except Exception as e:   # noqa: BLE001 — report, don't crash the sweep
        res.error = f"{type(e).__name__}: {e}"
        return res
    host = tuple(x.double().cpu().numpy() for x in operands)
    if stacked:
        want = np.stack([oracle(op, tuple(x[i] for x in host), alpha=alpha,
                                beta=beta, variant=variant)
                         for i in range(stacked)])
    else:
        want = oracle(op, host, alpha=alpha, beta=beta, variant=variant)
    if got.shape != want.shape:     # before the subtraction: a wrong shape
        res.error = f"shape {got.shape} != {want.shape}"    # may not even
        return res                                          # broadcast
    n_in = 1 if op == "syrk" else 2
    res.rel_err = float(np.max(np.abs(got - want)) /
                        (error_scale(op, host[:n_in], want, alpha=alpha)
                         + 1e-9))
    res.ok = res.rel_err < tol
    return res


def run_conformance(backends=None, ops=None,
                    dtypes=(torch.float32, torch.float64), *,
                    tol: float | None = None, stacked_width: int = 0,
                    ragged: bool = False,
                    device=None) -> list[ConformanceResult]:
    """The full sweep: every backend × its ops × dtypes (+ optionally the
    stacked path at ``stacked_width``); ``ragged`` additionally sweeps every
    cell over :data:`RAGGED_DIMS`.  Returns one result per cell."""
    names = tuple(backends) if backends else available_backends()
    results = []
    for name in names:
        be = get_backend(name)
        for op in (tuple(ops) if ops else be.ops()):
            for dtype in dtypes:
                dims_sweep = [None]
                if ragged:
                    dims_sweep += list(RAGGED_DIMS[op])
                for dims in dims_sweep:
                    results.append(check_backend_op(name, op, dtype,
                                                    dims=dims, tol=tol,
                                                    device=device))
                    if stacked_width:
                        results.append(check_backend_op(
                            name, op, dtype, dims=dims, tol=tol,
                            stacked=stacked_width, device=device))
    return results
