"""XGBoost-style gradient-boosted trees (second-order, L2 leaf shrinkage).

For squared loss the Hessian is 1, so the XGBoost leaf weight
``w* = -G/(H + λ)`` reduces to ``sum(residual)/(n_leaf + λ)`` — standard GBT
with an L2-regularised leaf value plus learning-rate shrinkage, subsampling
and early stopping on a holdout.  This is the paper's ``XGBRegressor``
candidate implemented numpy-only.
"""

from __future__ import annotations

import numpy as np

from .base import Estimator, register
from .tree import ArrayTree

__all__ = ["XGBoost"]


@register
class XGBoost(Estimator):
    NAME = "XGBoost"
    PARAM_GRID = {"n_estimators": [100, 200], "max_depth": [3, 4, 6],
                  "learning_rate": [0.05, 0.1, 0.2],
                  "reg_lambda": [0.0, 1.0]}

    def __init__(self, n_estimators: int = 200, max_depth: int = 4,
                 learning_rate: float = 0.1, reg_lambda: float = 1.0,
                 subsample: float = 0.9, early_stopping_rounds: int = 25,
                 seed: int = 0) -> None:
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.reg_lambda = reg_lambda
        self.subsample = subsample
        self.early_stopping_rounds = early_stopping_rounds
        self.seed = seed
        self.base_: float = 0.0
        self.trees_: list[ArrayTree] = []

    def _shrink_leaves(self, tree: ArrayTree, X, residual, reg_lambda):
        """Recompute leaf values with L2 shrinkage: sum(res)/(count+λ)."""
        leaf_of = self._leaf_index(tree, X)
        nleaf = tree.value.shape[0]
        sums = np.bincount(leaf_of, weights=residual, minlength=nleaf)
        cnts = np.bincount(leaf_of, minlength=nleaf).astype(np.float64)
        is_leaf = tree.feature == -1
        new_val = np.where(cnts > 0,
                           sums / np.maximum(cnts + reg_lambda, 1e-12),
                           tree.value)
        tree.value = np.where(is_leaf, new_val, tree.value)

    @staticmethod
    def _leaf_index(tree: ArrayTree, X: np.ndarray) -> np.ndarray:
        node = np.zeros(X.shape[0], dtype=np.int32)
        for _ in range(tree.depth + 1):
            f = tree.feature[node]
            is_split = f != -1
            if not is_split.any():
                break
            fx = X[np.arange(X.shape[0]), np.maximum(f, 0)]
            nxt = np.where(fx <= tree.threshold[node],
                           tree.left[node], tree.right[node])
            node = np.where(is_split, nxt, node)
        return node

    def fit(self, X, y):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = X.shape[0]
        rng = np.random.default_rng(self.seed)
        # holdout for early stopping
        perm = rng.permutation(n)
        n_val = max(1, int(0.15 * n)) if n >= 20 else 0
        val_idx, tr_idx = perm[:n_val], perm[n_val:]
        Xt, yt = X[tr_idx], y[tr_idx]
        Xv, yv = X[val_idx], y[val_idx]

        self.base_ = float(y.mean())
        pred_t = np.full(len(yt), self.base_)
        pred_v = np.full(len(yv), self.base_)
        self.trees_ = []
        best_val = np.inf
        best_len = 0
        for _ in range(self.n_estimators):
            residual = yt - pred_t
            if self.subsample < 1.0:
                m = rng.random(len(yt)) < self.subsample
                if m.sum() < 8:
                    m[:] = True
            else:
                m = np.ones(len(yt), dtype=bool)
            t = ArrayTree().build(Xt[m], residual[m], np.ones(int(m.sum())),
                                  max_depth=self.max_depth,
                                  min_samples_leaf=2, max_features=None,
                                  rng=rng)
            self._shrink_leaves(t, Xt[m], residual[m], self.reg_lambda)
            pred_t += self.learning_rate * t.predict(Xt)
            self.trees_.append(t)
            if n_val:
                pred_v += self.learning_rate * t.predict(Xv)
                val_rmse = float(np.sqrt(np.mean((yv - pred_v) ** 2)))
                if val_rmse < best_val - 1e-12:
                    best_val = val_rmse
                    best_len = len(self.trees_)
                elif len(self.trees_) - best_len >= self.early_stopping_rounds:
                    break
        if n_val and best_len:
            self.trees_ = self.trees_[:best_len]
        return self

    def predict(self, X):
        X = np.asarray(X, dtype=np.float64)
        out = np.full(X.shape[0], self.base_)
        for t in self.trees_:
            out += self.learning_rate * t.predict(X)
        return out

    def get_state(self):
        return {"trees": [t.get_state() for t in self.trees_],
                "base": self.base_, "lr": self.learning_rate,
                "params": self.get_params()}

    def set_state(self, s):
        self.set_params(**{k: v for k, v in s["params"].items()})
        self.base_ = float(s["base"])
        self.learning_rate = float(s["lr"])
        self.trees_ = []
        for ts in s["trees"]:
            t = ArrayTree()
            t.set_state(ts)
            self.trees_.append(t)
