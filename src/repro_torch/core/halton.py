"""Scrambled Halton quasi-random sequences (paper §IV-B).

The paper samples matrix-dimension space with a *scrambled* Halton sequence
(bases 2, 3, 4 for ``m, k, n``; bases 2, 3 for two-dimension subroutines) to
obtain low-discrepancy coverage while breaking the inter-dimension correlation
of the plain Halton sequence [Mascagni & Chi 2004].

We implement digit-permutation scrambling: for base ``b`` a fixed random
permutation ``pi_b`` of ``{0..b-1}`` (with ``pi_b(0)=0`` so the sequence stays
in (0,1)) is applied to every radical-inverse digit.  The permutation is drawn
from a seeded generator so sampling is reproducible per installation.
"""

from __future__ import annotations

import numpy as np

__all__ = ["halton_sequence", "scrambled_halton", "sample_dims"]

# Paper: bases 2,3,4 for (m,k,n); 2,3 for (m,n).  Base 4 is not prime; the
# paper uses it anyway — we honour that choice (radical inverse is well defined
# for any integer base >= 2).
BASES_3D = (2, 3, 4)
BASES_2D = (2, 3)


def _radical_inverse(indices: np.ndarray, base: int,
                     perm: np.ndarray | None = None) -> np.ndarray:
    """Vectorised (optionally scrambled) radical inverse of ``indices``."""
    idx = np.asarray(indices, dtype=np.int64).copy()
    out = np.zeros(idx.shape, dtype=np.float64)
    f = 1.0
    while np.any(idx > 0):
        f /= base
        digit = idx % base
        if perm is not None:
            digit = perm[digit]
        out += f * digit
        idx //= base
    return out


def _digit_permutation(base: int, rng: np.random.Generator) -> np.ndarray:
    """Random digit permutation fixing 0 (keeps points strictly inside (0,1))."""
    p = 1 + rng.permutation(base - 1)
    return np.concatenate([[0], p]).astype(np.int64)


def halton_sequence(n: int, bases: tuple[int, ...], *, start: int = 1) -> np.ndarray:
    """Plain Halton sequence, shape (n, len(bases)), values in (0, 1)."""
    idx = np.arange(start, start + n)
    return np.stack([_radical_inverse(idx, b) for b in bases], axis=1)


def scrambled_halton(n: int, bases: tuple[int, ...], *, seed: int = 0,
                     start: int = 1) -> np.ndarray:
    """Scrambled Halton sequence, shape (n, len(bases)), values in (0, 1)."""
    rng = np.random.default_rng(seed)
    idx = np.arange(start, start + n)
    cols = []
    for b in bases:
        perm = _digit_permutation(b, rng)
        cols.append(_radical_inverse(idx, b, perm))
    return np.stack(cols, axis=1)


def sample_dims(
    n: int,
    ndims: int,
    *,
    lo: int = 16,
    hi: int = 4096,
    max_footprint_bytes: int | None = None,
    footprint_fn=None,
    seed: int = 0,
    log_scale: bool = True,
) -> np.ndarray:
    """Sample ``n`` integer dimension tuples via scrambled Halton.

    Mirrors the paper's install-time sampling: quasi-random points are mapped
    into ``[lo, hi]`` (log-scaled by default so small/slim matrices are well
    represented) and rejected when ``footprint_fn(dims) > max_footprint_bytes``
    (the paper caps the summed matrix size at 500 MB; we keep the cap a
    parameter because the calibration budget differs per machine).

    Returns an (n, ndims) int64 array.
    """
    bases = BASES_3D[:ndims] if ndims == 3 else BASES_2D[:ndims]
    out = np.empty((0, ndims), dtype=np.int64)
    start = 1
    attempts = 0
    while out.shape[0] < n and attempts < 64:
        u = scrambled_halton(2 * n, bases, seed=seed, start=start)
        start += 2 * n
        attempts += 1
        if log_scale:
            dims = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
        else:
            dims = lo + u * (hi - lo)
        dims = np.maximum(np.rint(dims).astype(np.int64), 1)
        if max_footprint_bytes is not None and footprint_fn is not None:
            keep = np.array([footprint_fn(tuple(d)) <= max_footprint_bytes
                             for d in dims])
            dims = dims[keep]
        out = np.concatenate([out, dims], axis=0)
    return out[:n]
