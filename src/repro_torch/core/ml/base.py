"""Base estimator interface for the from-scratch ML library.

Every model implements::

    fit(X, y) -> self
    predict(X) -> (n,) float64
    get_params() / set_params(**p)           # hyper-parameter tuning
    get_state() / set_state(state)           # persistence (plain dict of
                                             # numpy arrays / scalars / lists)

plus a class-level ``PARAM_GRID`` used by ``core.ml.tuning`` for random
search.  Registry lookup is by ``NAME``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Estimator", "MODEL_REGISTRY", "register", "make_model"]

MODEL_REGISTRY: dict[str, type] = {}


def register(cls):
    MODEL_REGISTRY[cls.NAME] = cls
    return cls


def make_model(name: str, **params) -> "Estimator":
    return MODEL_REGISTRY[name](**params)


class Estimator:
    NAME = "base"
    PARAM_GRID: dict[str, list] = {}

    def fit(self, X: np.ndarray, y: np.ndarray) -> "Estimator":
        raise NotImplementedError

    def predict(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- hyper-parameters --------------------------------------------------
    def get_params(self) -> dict:
        return {k: getattr(self, k) for k in self.PARAM_GRID}

    def set_params(self, **params) -> "Estimator":
        for k, v in params.items():
            setattr(self, k, v)
        return self

    # -- persistence -------------------------------------------------------
    def get_state(self) -> dict:
        raise NotImplementedError

    def set_state(self, state: dict) -> None:
        raise NotImplementedError

    def clone(self) -> "Estimator":
        return type(self)(**self.get_params())
