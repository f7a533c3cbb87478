"""Linear model family: OLS, Ridge, ElasticNet (coordinate descent),
Bayesian ridge (evidence maximization).  numpy-only.
"""

from __future__ import annotations

import numpy as np

from .base import Estimator, register

__all__ = ["LinearRegression", "Ridge", "ElasticNet", "BayesianRidge"]


def _add_bias(X: np.ndarray) -> np.ndarray:
    return np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)


def _matvec(X: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Deterministic row-wise X @ w.

    BLAS gemv processes rows in blocks whose FMA arrangement depends on row
    position and buffer alignment, so bit-identical rows can yield
    different low bits — which breaks tie-stability of the runtime's argmin
    knob decision (equal-feature candidates must predict equal times).
    einsum's fixed reduction order is alignment- and row-position-stable,
    and normalising to one memory layout makes the result a function of the
    VALUES alone: the same row predicts the same bits no matter which
    buffer (reference pipeline, fast-path single, fast-path batch) it
    arrived in.
    """
    return np.einsum("ij,j->i", np.ascontiguousarray(X), w)


@register
class LinearRegression(Estimator):
    NAME = "LinearRegression"
    PARAM_GRID: dict[str, list] = {}

    def __init__(self) -> None:
        self.coef_: np.ndarray | None = None

    def fit(self, X, y):
        Xb = _add_bias(np.asarray(X, dtype=np.float64))
        self.coef_, *_ = np.linalg.lstsq(Xb, np.asarray(y, dtype=np.float64),
                                         rcond=None)
        return self

    def predict(self, X):
        return _matvec(_add_bias(np.asarray(X, dtype=np.float64)), self.coef_)

    def get_state(self):
        return {"coef": self.coef_}

    def set_state(self, s):
        self.coef_ = np.asarray(s["coef"], dtype=np.float64)


@register
class Ridge(Estimator):
    NAME = "Ridge"
    PARAM_GRID = {"alpha": [0.01, 0.1, 1.0, 10.0]}

    def __init__(self, alpha: float = 1.0) -> None:
        self.alpha = alpha
        self.coef_: np.ndarray | None = None

    def fit(self, X, y):
        Xb = _add_bias(np.asarray(X, dtype=np.float64))
        d = Xb.shape[1]
        reg = self.alpha * np.eye(d)
        reg[-1, -1] = 0.0  # don't penalise the bias
        self.coef_ = np.linalg.solve(Xb.T @ Xb + reg, Xb.T @ np.asarray(y))
        return self

    def predict(self, X):
        return _matvec(_add_bias(np.asarray(X, dtype=np.float64)), self.coef_)

    def get_state(self):
        return {"coef": self.coef_, "alpha": self.alpha}

    def set_state(self, s):
        self.coef_ = np.asarray(s["coef"], dtype=np.float64)
        self.alpha = float(s["alpha"])


@register
class ElasticNet(Estimator):
    """ElasticNet via cyclic coordinate descent on centred data."""
    NAME = "ElasticNet"
    PARAM_GRID = {"alpha": [1e-4, 1e-3, 1e-2, 1e-1],
                  "l1_ratio": [0.2, 0.5, 0.8]}

    def __init__(self, alpha: float = 1e-3, l1_ratio: float = 0.5,
                 max_iter: int = 300, tol: float = 1e-8) -> None:
        self.alpha = alpha
        self.l1_ratio = l1_ratio
        self.max_iter = max_iter
        self.tol = tol
        self.coef_: np.ndarray | None = None
        self.intercept_: float = 0.0
        self._x_mean: np.ndarray | None = None
        self._y_mean: float = 0.0

    def fit(self, X, y):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n, d = X.shape
        self._x_mean = X.mean(axis=0)
        self._y_mean = float(y.mean())
        Xc = X - self._x_mean
        yc = y - self._y_mean
        l1 = self.alpha * self.l1_ratio * n
        l2 = self.alpha * (1.0 - self.l1_ratio) * n
        col_sq = (Xc ** 2).sum(axis=0) + l2
        col_sq = np.where(col_sq > 1e-12, col_sq, 1.0)
        w = np.zeros(d)
        r = yc.copy()                      # residual = yc - Xc @ w
        for _ in range(self.max_iter):
            w_max_delta = 0.0
            for j in range(d):
                wj = w[j]
                rho = Xc[:, j] @ r + wj * (col_sq[j] - l2)
                # soft threshold
                nj = np.sign(rho) * max(abs(rho) - l1, 0.0) / col_sq[j]
                if nj != wj:
                    r -= (nj - wj) * Xc[:, j]
                    w[j] = nj
                    w_max_delta = max(w_max_delta, abs(nj - wj))
            if w_max_delta < self.tol:
                break
        self.coef_ = w
        self.intercept_ = self._y_mean - float(self._x_mean @ w)
        return self

    def predict(self, X):
        return _matvec(np.asarray(X, dtype=np.float64), self.coef_) + self.intercept_

    def get_state(self):
        return {"coef": self.coef_, "intercept": self.intercept_,
                "alpha": self.alpha, "l1_ratio": self.l1_ratio}

    def set_state(self, s):
        self.coef_ = np.asarray(s["coef"], dtype=np.float64)
        self.intercept_ = float(s["intercept"])
        self.alpha = float(s["alpha"])
        self.l1_ratio = float(s["l1_ratio"])


@register
class BayesianRidge(Estimator):
    """Bayesian linear regression with evidence-maximised precisions
    (MacKay-style iterative update of alpha=noise, lambda=weights)."""
    NAME = "BayesianRidge"
    PARAM_GRID = {"max_iter": [300]}

    def __init__(self, max_iter: int = 300, tol: float = 1e-6) -> None:
        self.max_iter = max_iter
        self.tol = tol
        self.coef_: np.ndarray | None = None
        self.alpha_: float = 1.0    # noise precision
        self.lambda_: float = 1.0   # weight precision

    def fit(self, X, y):
        Xb = _add_bias(np.asarray(X, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64)
        n, d = Xb.shape
        XtX = Xb.T @ Xb
        Xty = Xb.T @ y
        eigvals = np.linalg.eigvalsh(XtX)
        eigvals = np.maximum(eigvals, 0.0)
        alpha, lam = 1.0 / max(np.var(y), 1e-12), 1.0
        mn = np.zeros(d)
        for _ in range(self.max_iter):
            A = lam * np.eye(d) + alpha * XtX
            mn_new = alpha * np.linalg.solve(A, Xty)
            gamma = float(np.sum(alpha * eigvals / (lam + alpha * eigvals)))
            lam_new = gamma / max(float(mn_new @ mn_new), 1e-300)
            resid = y - Xb @ mn_new
            alpha_new = max(n - gamma, 1e-6) / max(float(resid @ resid), 1e-300)
            done = (abs(np.log(max(lam_new, 1e-300)) - np.log(max(lam, 1e-300)))
                    < self.tol)
            mn, lam, alpha = mn_new, lam_new, alpha_new
            if done:
                break
        self.coef_, self.alpha_, self.lambda_ = mn, alpha, lam
        return self

    def predict(self, X):
        return _matvec(_add_bias(np.asarray(X, dtype=np.float64)), self.coef_)

    def get_state(self):
        return {"coef": self.coef_, "alpha": self.alpha_, "lambda": self.lambda_}

    def set_state(self, s):
        self.coef_ = np.asarray(s["coef"], dtype=np.float64)
        self.alpha_ = float(s["alpha"])
        self.lambda_ = float(s["lambda"])
