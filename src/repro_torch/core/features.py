"""Feature engineering for BLAS L3 runtime models (paper Table III).

Two feature sets, chosen by the number of free matrix dimensions of the
subroutine:

  3-dim (GEMM):                m, k, n, nt, m*k, m*n, k*n, m*k*n, footprint,
                               m/nt, k/nt, n/nt, m*k/nt, m*n/nt, k*n/nt,
                               m*k*n/nt, footprint/nt
  2-dim (SYMM/SYRK/SYR2K/TRMM/TRSM):
                               m, n, nt, m*n, footprint,
                               m/nt, n/nt, m*n/nt, footprint/nt

``nt`` is the parallelism measure of the execution config (thread count on
CPU; number of parallel Pallas grid cells on TPU — see DESIGN.md §2).
``footprint`` is the summed size, in words, of the matrices the subroutine
reads/writes (paper footnote 1: overwritten operands counted once).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "SUBROUTINES", "SUBROUTINE_NDIMS", "footprint_words",
    "footprint_words_vec",
    "feature_names", "build_features",
    "fill_features_into", "fill_features_batch",
]

# dims per subroutine (paper Table I). GEMM: (m,k,n); SYMM/TRMM/TRSM: (m,n);
# SYRK/SYR2K: (n,k) — treated as the generic 2-dim pair, in listed order.
SUBROUTINE_NDIMS = {
    "gemm": 3,
    "symm": 2,
    "syrk": 2,
    "syr2k": 2,
    "trmm": 2,
    "trsm": 2,
}
SUBROUTINES = tuple(SUBROUTINE_NDIMS)


def footprint_words(op: str, dims: tuple[int, ...]) -> int:
    """Summed matrix sizes in words (paper's memory_footprint feature)."""
    if op == "gemm":
        m, k, n = dims
        return m * k + k * n + m * n
    if op == "symm":
        m, n = dims
        return m * m + 2 * m * n           # A(mxm) + B(mxn) + C(mxn)
    if op == "syrk":
        n, k = dims
        return n * k + n * n               # A(nxk) + C(nxn)
    if op == "syr2k":
        n, k = dims
        return 2 * n * k + n * n           # A + B (nxk) + C(nxn)
    if op in ("trmm", "trsm"):
        m, n = dims
        return m * m + m * n               # A(mxm) + B(mxn); B overwritten
    raise ValueError(f"unknown subroutine {op!r}")


def footprint_words_vec(op: str, dims: np.ndarray) -> np.ndarray:
    """Vectorised footprint (runtime eval path: called per BLAS decision)."""
    d = np.asarray(dims, dtype=np.float64)
    if op == "gemm":
        m, k, n = d[:, 0], d[:, 1], d[:, 2]
        return m * k + k * n + m * n
    a, b = d[:, 0], d[:, 1]
    if op == "symm":
        return a * a + 2 * a * b
    if op == "syrk":
        return a * b + a * a
    if op == "syr2k":
        return 2 * a * b + a * a
    return a * a + a * b          # trmm / trsm


def feature_names(ndims: int) -> list[str]:
    if ndims == 3:
        return [
            "m", "k", "n", "nt",
            "m*k", "m*n", "k*n", "m*k*n", "footprint",
            "m/nt", "k/nt", "n/nt",
            "m*k/nt", "m*n/nt", "k*n/nt", "m*k*n/nt", "footprint/nt",
        ]
    if ndims == 2:
        return [
            "m", "n", "nt", "m*n", "footprint",
            "m/nt", "n/nt", "m*n/nt", "footprint/nt",
        ]
    raise ValueError(f"ndims must be 2 or 3, got {ndims}")


def build_features(op: str, dims: np.ndarray, nt: np.ndarray) -> np.ndarray:
    """Build the Table-III feature matrix.

    dims: (N, ndims) int array of matrix dimensions.
    nt:   (N,) parallelism measure per sample.
    Returns (N, n_features) float64.
    """
    dims = np.asarray(dims, dtype=np.float64)
    nt = np.asarray(nt, dtype=np.float64).reshape(-1)
    ndims = SUBROUTINE_NDIMS[op]
    assert dims.shape[1] == ndims, (op, dims.shape)
    fp = footprint_words_vec(op, dims)
    if ndims == 3:
        m, k, n = dims[:, 0], dims[:, 1], dims[:, 2]
        cols = [
            m, k, n, nt,
            m * k, m * n, k * n, m * k * n, fp,
            m / nt, k / nt, n / nt,
            m * k / nt, m * n / nt, k * n / nt, m * k * n / nt, fp / nt,
        ]
    else:
        m, n = dims[:, 0], dims[:, 1]
        cols = [
            m, n, nt, m * n, fp,
            m / nt, n / nt, m * n / nt, fp / nt,
        ]
    return np.stack(cols, axis=1)


# ---------------------------------------------------------------------------
# fused column building (the compiled runtime fast path)
# ---------------------------------------------------------------------------

#: sentinel marking "this column IS the parallelism vector"
_NT = object()


def _term_spec(op: str, d: tuple) -> tuple:
    """Ordered Table-III column spec at fixed dims.

    ``d`` holds one value per free dim — np.float64 scalars (single call) or
    ``(B, 1)`` float64 arrays (batched).  Each entry is either a dims-only
    value (constant across candidates), the ``_NT`` sentinel, or a 1-tuple
    ``(numerator,)`` meaning ``numerator / nt``.  Every expression repeats
    :func:`build_features` / :func:`footprint_words_vec` term by term (same
    association order, float64 throughout), so filled columns are
    bit-identical to the reference matrix's.
    """
    if SUBROUTINE_NDIMS[op] == 3:
        m, k, n = d
        mk = m * k
        mn = m * n
        kn = k * n
        mkn = mk * n
        fp = mk + kn + mn
        return (m, k, n, _NT, mk, mn, kn, mkn, fp,
                (m,), (k,), (n,), (mk,), (mn,), (kn,), (mkn,), (fp,))
    m, n = d
    mn = m * n
    if op == "symm":
        fp = m * m + 2 * m * n
    elif op == "syrk":
        fp = m * n + m * m
    elif op == "syr2k":
        fp = 2 * m * n + m * m
    else:                               # trmm / trsm
        fp = m * m + m * n
    return (m, n, _NT, mn, fp, (m,), (n,), (mn,), (fp,))


def fill_features_into(op: str, dims: tuple, nt: np.ndarray,
                       col_idx: np.ndarray, out: np.ndarray) -> None:
    """Write the selected Table-III columns for ONE dims into ``out``.

    Bit-identical to ``build_features(op, tile(dims), nt)[:, col_idx]`` but
    with no tiling, no unused columns, and no intermediate stacking —
    ``out`` is the caller's preallocated ``(K, len(col_idx))`` buffer.
    """
    spec = _term_spec(op, tuple(np.float64(v) for v in dims))
    for j, c in enumerate(col_idx):
        s = spec[c]
        if type(s) is tuple:
            np.divide(s[0], nt, out=out[:, j])
        elif s is _NT:
            out[:, j] = nt
        else:
            out[:, j] = s


def fill_features_batch(op: str, dims_arr: np.ndarray, nt: np.ndarray,
                        col_idx: np.ndarray, out: np.ndarray) -> None:
    """Batched :func:`fill_features_into`: ``dims_arr`` is ``(B, ndims)``,
    ``nt`` is ``(B, K)``, ``out`` is the ``(B, K, len(col_idx))`` buffer.
    Item ``b`` of ``out`` is bit-identical to a single-dims fill."""
    d = tuple(dims_arr[:, i:i + 1] for i in range(dims_arr.shape[1]))
    spec = _term_spec(op, d)
    for j, c in enumerate(col_idx):
        s = spec[c]
        if type(s) is tuple:
            np.divide(s[0], nt, out=out[:, :, j])
        elif s is _NT:
            out[:, :, j] = nt
        else:
            out[:, :, j] = s
