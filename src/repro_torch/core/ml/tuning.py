"""Hyper-parameter tuning: seeded random search over PARAM_GRID with K-fold
CV (paper §IV-C: "the hyperparameter tuning is performed for all models")."""

from __future__ import annotations

import itertools

import numpy as np

from .base import Estimator
from .metrics import cross_val_rmse

__all__ = ["tune_model"]


def tune_model(model: Estimator, X: np.ndarray, y: np.ndarray, *,
               n_trials: int = 8, cv: int = 3, seed: int = 0) -> Estimator:
    """Return a freshly-fitted model with the best CV hyper-parameters."""
    grid = model.PARAM_GRID
    if not grid:
        return model.clone().fit(X, y)
    keys = sorted(grid)
    combos = list(itertools.product(*[grid[k] for k in keys]))
    rng = np.random.default_rng(seed)
    if len(combos) > n_trials:
        picks = rng.choice(len(combos), size=n_trials, replace=False)
        combos = [combos[i] for i in picks]
    best_params, best_err = None, np.inf
    for combo in combos:
        params = dict(zip(keys, combo))
        cand = model.clone().set_params(**params)
        err = cross_val_rmse(cand, X, y, k=cv, seed=seed)
        if err < best_err:
            best_err, best_params = err, params
    out = model.clone().set_params(**(best_params or {}))
    out.fit(X, y)
    return out
