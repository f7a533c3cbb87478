"""Local Outlier Factor (paper §II-C) — density-based outlier removal.

Brute-force numpy implementation (datasets are ~10^3 points × ≤15 dims, so
O(n²) distances are trivial).  Matches Breunig et al. 2000:

    reach-dist_k(a,b) = max(k-distance(b), d(a,b))
    lrd_k(a)          = 1 / mean_{b in kNN(a)} reach-dist_k(a,b)
    LOF_k(a)          = mean_{b in kNN(a)} lrd_k(b) / lrd_k(a)

Points with LOF above ``threshold`` are flagged as local outliers.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lof_scores", "remove_outliers"]


def lof_scores(X: np.ndarray, k: int = 20) -> np.ndarray:
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    k = min(k, n - 1)
    if k < 1:
        return np.ones(n)
    # pairwise distances
    sq = (X ** 2).sum(axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (X @ X.T)
    np.fill_diagonal(d2, np.inf)
    d = np.sqrt(np.maximum(d2, 0.0))
    # k nearest neighbours
    nn_idx = np.argpartition(d, k - 1, axis=1)[:, :k]           # (n, k)
    nn_d = np.take_along_axis(d, nn_idx, axis=1)                # (n, k)
    k_dist = nn_d.max(axis=1)                                   # k-distance(b)
    # reachability distance of each point from its neighbours
    reach = np.maximum(k_dist[nn_idx], nn_d)                    # (n, k)
    lrd = 1.0 / np.maximum(reach.mean(axis=1), 1e-300)
    lof = (lrd[nn_idx].mean(axis=1)) / lrd
    return lof


def remove_outliers(X: np.ndarray, y: np.ndarray, *, k: int = 20,
                    threshold: float = 1.5) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (X_clean, y_clean, keep_mask); outliers scored on [X | y]."""
    y = np.asarray(y, dtype=np.float64)
    # standardize jointly so runtime outliers count too (timing noise spikes)
    Z = np.concatenate([X, y[:, None]], axis=1)
    mu, sd = Z.mean(axis=0), Z.std(axis=0)
    Z = (Z - mu) / np.where(sd > 1e-12, sd, 1.0)
    scores = lof_scores(Z, k=k)
    keep = scores <= threshold
    # never drop more than 10% of the data (guard against aggressive k)
    if keep.sum() < 0.9 * len(keep):
        order = np.argsort(scores)
        keep = np.zeros(len(keep), dtype=bool)
        keep[order[: int(np.ceil(0.9 * len(order)))]] = True
    return X[keep], y[keep], keep
