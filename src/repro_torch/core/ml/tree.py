"""Array-based CART regression tree (variance-reduction splits).

The tree is stored as flat numpy arrays (feature, threshold, left, right,
value) so that (a) predict is a vectorised iterative descent, (b) the model
serialises to plain arrays for the registry, and (c) ensembles stay compact.

Split search is exact: per feature, sort once, scan prefix sums of y and y²
to evaluate the variance reduction of every split point — O(d · n log n) per
node, vectorised over split positions.
"""

from __future__ import annotations

import numpy as np

from .base import Estimator, register

__all__ = ["DecisionTree", "ArrayTree"]

_LEAF = -1


class ArrayTree:
    """Flat-array binary regression tree."""

    def __init__(self) -> None:
        self.feature: np.ndarray = np.zeros(0, dtype=np.int32)
        self.threshold: np.ndarray = np.zeros(0, dtype=np.float64)
        self.left: np.ndarray = np.zeros(0, dtype=np.int32)
        self.right: np.ndarray = np.zeros(0, dtype=np.int32)
        self.value: np.ndarray = np.zeros(0, dtype=np.float64)
        self.depth: int = 0

    # -- construction -------------------------------------------------------
    def build(self, X: np.ndarray, y: np.ndarray, sample_weight: np.ndarray,
              *, max_depth: int, min_samples_leaf: int,
              max_features: int | None, rng: np.random.Generator,
              min_impurity_decrease: float = 0.0) -> "ArrayTree":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        w = np.asarray(sample_weight, dtype=np.float64)

        feat, thr, left, right, val = [], [], [], [], []

        def new_node() -> int:
            feat.append(_LEAF)
            thr.append(0.0)
            left.append(_LEAF)
            right.append(_LEAF)
            val.append(0.0)
            return len(feat) - 1

        max_seen_depth = 0

        def grow(idx: np.ndarray, depth: int) -> int:
            nonlocal max_seen_depth
            max_seen_depth = max(max_seen_depth, depth)
            node = new_node()
            yi, wi = y[idx], w[idx]
            wsum = wi.sum()
            mean = float((wi * yi).sum() / max(wsum, 1e-300))
            val[node] = mean
            if depth >= max_depth or idx.size < 2 * min_samples_leaf:
                return node
            best = _best_split(X[idx], yi, wi, min_samples_leaf,
                               max_features, rng)
            if best is None or best[2] <= min_impurity_decrease:
                return node
            j, t, _gain = best
            mask = X[idx, j] <= t
            li, ri = idx[mask], idx[~mask]
            if li.size < min_samples_leaf or ri.size < min_samples_leaf:
                return node
            feat[node] = j
            thr[node] = t
            left[node] = grow(li, depth + 1)
            right[node] = grow(ri, depth + 1)
            return node

        grow(np.arange(X.shape[0]), 0)
        self.feature = np.asarray(feat, dtype=np.int32)
        self.threshold = np.asarray(thr, dtype=np.float64)
        self.left = np.asarray(left, dtype=np.int32)
        self.right = np.asarray(right, dtype=np.int32)
        self.value = np.asarray(val, dtype=np.float64)
        self.depth = max_seen_depth
        return self

    # -- inference ----------------------------------------------------------
    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        node = np.zeros(X.shape[0], dtype=np.int32)
        for _ in range(self.depth + 1):
            f = self.feature[node]
            is_split = f != _LEAF
            if not is_split.any():
                break
            fx = X[np.arange(X.shape[0]), np.maximum(f, 0)]
            go_left = fx <= self.threshold[node]
            nxt = np.where(go_left, self.left[node], self.right[node])
            node = np.where(is_split, nxt, node)
        return self.value[node]

    # -- predicated export ----------------------------------------------------
    def predicated_arrays(self) -> tuple:
        """``(feature, threshold, left, right)`` with leaves rewritten as
        self-loops: a leaf keeps feature 0, threshold ``+inf`` (every
        ``x <= +inf`` comparison goes left) and both children pointing back
        at itself.  Descending this layout a *fixed* number of levels is
        branchless — no per-level "all rows done?" check — and lands on the
        same node as the reference early-exit descent, because a finished
        row just spins on its leaf.  Comparisons and index lookups only, so
        any descent over these arrays is bit-identical to :meth:`predict`.
        """
        leaf = self.feature < 0
        nodes = np.arange(self.feature.size, dtype=np.int64)
        feat = np.where(leaf, 0, self.feature).astype(np.int64)
        thr = np.where(leaf, np.inf, self.threshold)
        left = np.where(leaf, nodes, self.left.astype(np.int64))
        right = np.where(leaf, nodes, self.right.astype(np.int64))
        return feat, thr, left, right

    # -- persistence ----------------------------------------------------------
    def get_state(self) -> dict:
        return {"feature": self.feature, "threshold": self.threshold,
                "left": self.left, "right": self.right, "value": self.value,
                "depth": self.depth}

    def set_state(self, s: dict) -> None:
        self.feature = np.asarray(s["feature"], dtype=np.int32)
        self.threshold = np.asarray(s["threshold"], dtype=np.float64)
        self.left = np.asarray(s["left"], dtype=np.int32)
        self.right = np.asarray(s["right"], dtype=np.int32)
        self.value = np.asarray(s["value"], dtype=np.float64)
        self.depth = int(s["depth"])


def _best_split(X: np.ndarray, y: np.ndarray, w: np.ndarray,
                min_samples_leaf: int, max_features: int | None,
                rng: np.random.Generator):
    """Exact best (feature, threshold, gain) by weighted variance reduction."""
    n, d = X.shape
    feats = np.arange(d)
    if max_features is not None and max_features < d:
        feats = rng.choice(d, size=max_features, replace=False)
    wy = w * y
    tot_w = w.sum()
    tot_wy = wy.sum()
    tot_wyy = (w * y * y).sum()
    base_sse = tot_wyy - tot_wy ** 2 / max(tot_w, 1e-300)
    best = None
    best_gain = 0.0
    for j in feats:
        order = np.argsort(X[:, j], kind="stable")
        xs = X[order, j]
        cw = np.cumsum(w[order])
        cwy = np.cumsum(wy[order])
        cwyy = np.cumsum((w * y * y)[order])
        # candidate split after position i (left = [0..i])
        i = np.arange(n - 1)
        valid = (xs[i] < xs[i + 1])
        if min_samples_leaf > 1:
            valid &= (i + 1 >= min_samples_leaf) & \
                     (n - (i + 1) >= min_samples_leaf)
        if not valid.any():
            continue
        lw, lwy, lwyy = cw[i], cwy[i], cwyy[i]
        rw, rwy, rwyy = tot_w - lw, tot_wy - lwy, tot_wyy - lwyy
        sse = (lwyy - lwy ** 2 / np.maximum(lw, 1e-300)) + \
              (rwyy - rwy ** 2 / np.maximum(rw, 1e-300))
        sse = np.where(valid, sse, np.inf)
        k = int(np.argmin(sse))
        gain = base_sse - sse[k]
        if gain > best_gain:
            best_gain = float(gain)
            best = (int(j), float((xs[k] + xs[k + 1]) / 2.0), float(gain))
    return best


@register
class DecisionTree(Estimator):
    NAME = "DecisionTree"
    PARAM_GRID = {"max_depth": [4, 6, 8, 12],
                  "min_samples_leaf": [1, 2, 5]}

    def __init__(self, max_depth: int = 8, min_samples_leaf: int = 2,
                 max_features: int | None = None, seed: int = 0) -> None:
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.seed = seed
        self.tree_ = ArrayTree()

    @property
    def trees_(self) -> tuple:
        """Uniform tree-model interface (ensembles expose ``trees_`` too):
        the compiled decision engine lowers every tree family through one
        table-driven representation."""
        return (self.tree_,)

    def fit(self, X, y):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        rng = np.random.default_rng(self.seed)
        self.tree_.build(X, y, np.ones(len(y)), max_depth=self.max_depth,
                         min_samples_leaf=self.min_samples_leaf,
                         max_features=self.max_features, rng=rng)
        return self

    def predict(self, X):
        return self.tree_.predict(X)

    def get_state(self):
        return {"tree": self.tree_.get_state(),
                "max_depth": self.max_depth,
                "min_samples_leaf": self.min_samples_leaf}

    def set_state(self, s):
        self.tree_.set_state(s["tree"])
        self.max_depth = int(s["max_depth"])
        self.min_samples_leaf = int(s["min_samples_leaf"])
