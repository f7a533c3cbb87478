"""k-Nearest-Neighbours regressor (brute-force, distance-weighted option).

Neighbour selection is *canonical*: the k nearest points ordered by
``(distance², original index)``.  ``np.argpartition`` (the usual brute-force
shortcut) breaks distance ties in an unspecified per-call order, which makes
the prediction's low-order bits depend on the partition algorithm — an
alternative exact implementation (the compiled KD/ball lookup in
:mod:`repro_torch.core.fastpath`) could then never reproduce it bit-for-bit.  A
stable argsort pins both the neighbour *set* and the summation *order*, so
any implementation that selects the same canonical neighbours computes the
identical float result.
"""

from __future__ import annotations

import numpy as np

from .base import Estimator, register

__all__ = ["KNN"]


@register
class KNN(Estimator):
    NAME = "KNN"
    PARAM_GRID = {"k": [3, 5, 9, 15], "weights": ["uniform", "distance"]}

    def __init__(self, k: int = 5, weights: str = "uniform") -> None:
        self.k = k
        self.weights = weights
        self.X_: np.ndarray | None = None
        self.y_: np.ndarray | None = None

    def fit(self, X, y):
        # C-contiguous training points for the same reason as predict's
        # query canonicalisation: an F-ordered training matrix (the
        # preprocess pipeline's natural output layout) would flip the
        # broadcast distance reduction to a strided, differently-associated
        # summation
        self.X_ = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
        self.y_ = np.asarray(y, dtype=np.float64)
        return self

    def predict(self, X):
        # C-contiguous queries pin the distance reduction's association
        # order regardless of the caller's buffer layout — any exact
        # alternative implementation then reproduces the same bits from
        # gathered candidate subsets
        X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
        k = min(self.k, self.X_.shape[0])
        # (q, n) squared distances
        d2 = ((X[:, None, :] - self.X_[None, :, :]) ** 2).sum(-1)
        # canonical neighbours: k smallest by (d2, index) — stable sort ties
        nn = np.argsort(d2, axis=1, kind="stable")[:, :k]
        ny = self.y_[nn]
        nd = np.sqrt(np.take_along_axis(d2, nn, axis=1)) \
            if self.weights == "distance" else None
        return self._combine(ny, nd)

    def _combine(self, ny: np.ndarray, nd: np.ndarray | None) -> np.ndarray:
        """Fold the ``(q, k)`` neighbour targets (and distances, for the
        ``distance`` weighting) into predictions.  Shared with the compiled
        fast path so both combine canonical neighbours with the exact same
        ufunc sequence (bit-identical results)."""
        if self.weights == "distance":
            w = 1.0 / np.maximum(nd, 1e-12)
            return (w * ny).sum(1) / w.sum(1)
        return ny.mean(1)

    def get_state(self):
        return {"X": self.X_, "y": self.y_, "k": self.k,
                "weights": self.weights}

    def set_state(self, s):
        self.X_ = np.ascontiguousarray(np.asarray(s["X"], dtype=np.float64))
        self.y_ = np.asarray(s["y"], dtype=np.float64)
        self.k = int(s["k"])
        self.weights = str(s["weights"])
