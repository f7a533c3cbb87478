"""Tree ensembles: RandomForest (bagging) and AdaBoost.R2."""

from __future__ import annotations

import numpy as np

from .base import Estimator, register
from .tree import ArrayTree

__all__ = ["RandomForest", "AdaBoost"]


@register
class RandomForest(Estimator):
    NAME = "RandomForest"
    PARAM_GRID = {"n_estimators": [50, 100], "max_depth": [8, 12, 16],
                  "max_features_frac": [0.5, 0.8, 1.0]}

    def __init__(self, n_estimators: int = 100, max_depth: int = 12,
                 min_samples_leaf: int = 1, max_features_frac: float = 0.8,
                 seed: int = 0) -> None:
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features_frac = max_features_frac
        self.seed = seed
        self.trees_: list[ArrayTree] = []

    def fit(self, X, y):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n, d = X.shape
        rng = np.random.default_rng(self.seed)
        mf = max(1, int(round(self.max_features_frac * d)))
        self.trees_ = []
        for _ in range(self.n_estimators):
            idx = rng.integers(0, n, size=n)          # bootstrap
            t = ArrayTree().build(X[idx], y[idx], np.ones(n),
                                  max_depth=self.max_depth,
                                  min_samples_leaf=self.min_samples_leaf,
                                  max_features=mf, rng=rng)
            self.trees_.append(t)
        return self

    def predict(self, X):
        X = np.asarray(X, dtype=np.float64)
        return np.mean([t.predict(X) for t in self.trees_], axis=0)

    def get_state(self):
        return {"trees": [t.get_state() for t in self.trees_],
                "params": self.get_params()}

    def set_state(self, s):
        self.set_params(**{k: v for k, v in s["params"].items()})
        self.trees_ = []
        for ts in s["trees"]:
            t = ArrayTree()
            t.set_state(ts)
            self.trees_.append(t)


@register
class AdaBoost(Estimator):
    """AdaBoost.R2 (Drucker 1997) with shallow regression-tree learners."""
    NAME = "AdaBoost"
    PARAM_GRID = {"n_estimators": [50, 100], "max_depth": [3, 4, 6]}

    def __init__(self, n_estimators: int = 50, max_depth: int = 4,
                 seed: int = 0) -> None:
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.seed = seed
        self.trees_: list[ArrayTree] = []
        self.betas_: np.ndarray = np.zeros(0)

    def fit(self, X, y):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = X.shape[0]
        rng = np.random.default_rng(self.seed)
        w = np.full(n, 1.0 / n)
        self.trees_, betas = [], []
        for _ in range(self.n_estimators):
            idx = rng.choice(n, size=n, p=w / w.sum())
            t = ArrayTree().build(X[idx], y[idx], np.ones(n),
                                  max_depth=self.max_depth,
                                  min_samples_leaf=1, max_features=None,
                                  rng=rng)
            pred = t.predict(X)
            err = np.abs(pred - y)
            emax = err.max()
            if emax <= 1e-300:
                self.trees_.append(t)
                betas.append(1e-6)
                break
            L = err / emax                       # linear loss
            ebar = float((w * L).sum() / w.sum())
            if ebar >= 0.5:
                break
            beta = ebar / (1.0 - ebar)
            w = w * np.power(beta, 1.0 - L)
            self.trees_.append(t)
            betas.append(beta)
        if not self.trees_:                      # fallback: single tree
            t = ArrayTree().build(X, y, np.ones(n), max_depth=self.max_depth,
                                  min_samples_leaf=1, max_features=None,
                                  rng=rng)
            self.trees_, betas = [t], [0.5]
        self.betas_ = np.asarray(betas)
        return self

    def predict(self, X):
        """Weighted-median prediction (AdaBoost.R2 combination rule)."""
        X = np.asarray(X, dtype=np.float64)
        preds = np.stack([t.predict(X) for t in self.trees_], axis=1)  # (n,T)
        logw = np.log(1.0 / np.maximum(self.betas_, 1e-300))
        order = np.argsort(preds, axis=1)
        sorted_preds = np.take_along_axis(preds, order, axis=1)
        cum = np.cumsum(logw[order], axis=1)
        half = 0.5 * logw.sum()
        pick = (cum >= half).argmax(axis=1)
        return sorted_preds[np.arange(X.shape[0]), pick]

    def get_state(self):
        return {"trees": [t.get_state() for t in self.trees_],
                "betas": self.betas_, "params": self.get_params()}

    def set_state(self, s):
        self.set_params(**{k: v for k, v in s["params"].items()})
        self.betas_ = np.asarray(s["betas"], dtype=np.float64)
        self.trees_ = []
        for ts in s["trees"]:
            t = ArrayTree()
            t.set_state(ts)
            self.trees_.append(t)
