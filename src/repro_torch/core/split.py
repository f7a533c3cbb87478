"""Stratified train/test split on runtime quantiles (paper §VI-A: stratified
sampling, 15% test)."""

from __future__ import annotations

import numpy as np

__all__ = ["stratified_split"]


def stratified_split(y: np.ndarray, *, test_frac: float = 0.15,
                     n_bins: int = 10, seed: int = 0):
    """Return (train_idx, test_idx), stratified over quantile bins of ``y``."""
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[0]
    rng = np.random.default_rng(seed)
    n_bins = max(1, min(n_bins, n // 4 or 1))
    edges = np.quantile(y, np.linspace(0, 1, n_bins + 1)[1:-1])
    bins = np.searchsorted(edges, y)
    train, test = [], []
    for b in np.unique(bins):
        idx = np.flatnonzero(bins == b)
        rng.shuffle(idx)
        k = int(round(test_frac * idx.size))
        test.append(idx[:k])
        train.append(idx[k:])
    train = np.concatenate(train) if train else np.arange(n)
    test = np.concatenate(test) if test else np.array([], dtype=np.int64)
    if test.size == 0 and n > 1:          # guarantee a non-empty test set
        train, test = train[:-1], train[-1:]
    return np.sort(train), np.sort(test)
