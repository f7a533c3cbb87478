"""Regression metrics + K-fold cross-validation."""

from __future__ import annotations

import numpy as np

__all__ = ["rmse", "normalized_rmse", "r2", "kfold_indices", "cross_val_rmse"]


def rmse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(y_true) - np.asarray(y_pred)) ** 2)))


def normalized_rmse(y_true: np.ndarray, y_pred: np.ndarray,
                    baseline_rmse: float | None = None) -> float:
    """RMSE normalised as in paper Table VI (relative to the worst linear
    model's RMSE when ``baseline_rmse`` given, else to the std of y)."""
    e = rmse(y_true, y_pred)
    denom = baseline_rmse if baseline_rmse else float(np.std(y_true)) or 1.0
    return e / max(denom, 1e-300)


def r2(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true)
    ss_res = float(np.sum((y_true - y_pred) ** 2))
    ss_tot = float(np.sum((y_true - y_true.mean()) ** 2))
    return 1.0 - ss_res / max(ss_tot, 1e-300)


def kfold_indices(n: int, k: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, k)
    for i in range(k):
        val = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        yield train, val


def cross_val_rmse(model, X: np.ndarray, y: np.ndarray, k: int = 3,
                   seed: int = 0) -> float:
    errs = []
    for tr, va in kfold_indices(len(y), k, seed):
        m = model.clone()
        m.fit(X[tr], y[tr])
        errs.append(rmse(y[va], m.predict(X[va])))
    return float(np.mean(errs))
