"""Data preprocessing: Yeo-Johnson power transform (MLE), standardization,
correlation-threshold feature pruning (paper §II-C, §IV-C).

All components are numpy-only (no scipy/sklearn in the environment), carry
``get_state()/set_state()`` for JSON/npz persistence, and are composed by
:class:`PreprocessPipeline` in the order the paper prescribes:

    Yeo-Johnson(MLE λ per feature) → standardize → corr-prune(|ρ| > 0.8)
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "yeo_johnson", "yeo_johnson_inverse", "YeoJohnsonTransformer",
    "StandardScaler", "CorrelationPruner", "PreprocessPipeline",
]


# ---------------------------------------------------------------------------
# Yeo-Johnson
# ---------------------------------------------------------------------------

def yeo_johnson(x: np.ndarray, lmbda: float) -> np.ndarray:
    """Yeo-Johnson transform of ``x`` with parameter ``lmbda``.

    Defined piecewise for x >= 0 and x < 0 [Yeo & Johnson 2000]; accepts
    non-positive values, unlike Box-Cox (the property the paper relies on).
    """
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)
    pos = x >= 0
    if abs(lmbda) > 1e-6:
        out[pos] = (np.power(x[pos] + 1.0, lmbda) - 1.0) / lmbda
    else:
        out[pos] = np.log1p(x[pos])
    if abs(lmbda - 2.0) > 1e-6:
        out[~pos] = -(np.power(1.0 - x[~pos], 2.0 - lmbda) - 1.0) / (2.0 - lmbda)
    else:
        out[~pos] = -np.log1p(-x[~pos])
    return out


def yeo_johnson_inverse(y: np.ndarray, lmbda: float) -> np.ndarray:
    """Inverse of :func:`yeo_johnson` (used in property tests)."""
    y = np.asarray(y, dtype=np.float64)
    out = np.empty_like(y)
    pos = y >= 0
    if abs(lmbda) > 1e-6:
        out[pos] = np.power(lmbda * y[pos] + 1.0, 1.0 / lmbda) - 1.0
    else:
        out[pos] = np.expm1(y[pos])
    if abs(lmbda - 2.0) > 1e-6:
        out[~pos] = 1.0 - np.power(-(2.0 - lmbda) * y[~pos] + 1.0,
                                   1.0 / (2.0 - lmbda))
    else:
        out[~pos] = -np.expm1(-y[~pos])
    return out


def _yj_log_likelihood(x: np.ndarray, lmbda: float) -> float:
    """Profile log-likelihood of λ under a Gaussian model (MLE objective)."""
    n = x.shape[0]
    y = yeo_johnson(x, lmbda)
    var = y.var()
    if var <= 1e-300 or not np.isfinite(var):
        return -np.inf
    ll = -0.5 * n * np.log(var)
    # Jacobian term: (λ-1)·Σ sign(x)·log(1+|x|)
    ll += (lmbda - 1.0) * np.sum(np.sign(x) * np.log1p(np.abs(x)))
    return float(ll)


def _fit_lambda(x: np.ndarray, lo: float = -3.0, hi: float = 3.0,
                coarse: int = 25, iters: int = 60) -> float:
    """MLE λ via coarse grid + golden-section refinement (scipy-free)."""
    grid = np.linspace(lo, hi, coarse)
    lls = np.array([_yj_log_likelihood(x, l) for l in grid])
    if not np.any(np.isfinite(lls)):
        return 1.0
    k = int(np.nanargmax(np.where(np.isfinite(lls), lls, -np.inf)))
    a = grid[max(k - 1, 0)]
    b = grid[min(k + 1, coarse - 1)]
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = _yj_log_likelihood(x, c), _yj_log_likelihood(x, d)
    for _ in range(iters):
        if fc > fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = _yj_log_likelihood(x, c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = _yj_log_likelihood(x, d)
        if abs(b - a) < 1e-4:
            break
    return float((a + b) / 2.0)


class YeoJohnsonTransformer:
    """Per-feature Yeo-Johnson with MLE-fitted λ (paper: MLE parameter est.)."""

    def __init__(self) -> None:
        self.lambdas_: np.ndarray | None = None

    def fit(self, X: np.ndarray) -> "YeoJohnsonTransformer":
        X = np.asarray(X, dtype=np.float64)
        self.lambdas_ = np.array([_fit_lambda(X[:, j])
                                  for j in range(X.shape[1])])
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        assert self.lambdas_ is not None, "fit first"
        X = np.asarray(X, dtype=np.float64)
        # vectorised over features (runtime eval path): both YJ branches
        # computed on the full matrix, selected by sign/λ masks
        lam = self.lambdas_[None, :]
        pos = X >= 0
        with np.errstate(divide="ignore", invalid="ignore"):
            p_gen = (np.power(np.where(pos, X, 0.0) + 1.0, lam) - 1.0) /                 np.where(np.abs(lam) > 1e-6, lam, 1.0)
            p_log = np.log1p(np.where(pos, X, 0.0))
            n_gen = -(np.power(1.0 - np.where(pos, 0.0, X), 2.0 - lam) - 1.0)                 / np.where(np.abs(2.0 - lam) > 1e-6, 2.0 - lam, 1.0)
            n_log = -np.log1p(-np.where(pos, 0.0, X))
        out = np.where(pos,
                       np.where(np.abs(lam) > 1e-6, p_gen, p_log),
                       np.where(np.abs(lam - 2.0) > 1e-6, n_gen, n_log))
        return out

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)

    def get_state(self) -> dict:
        return {"lambdas": self.lambdas_}

    def set_state(self, s: dict) -> None:
        self.lambdas_ = np.asarray(s["lambdas"], dtype=np.float64)


# ---------------------------------------------------------------------------
# Standardization
# ---------------------------------------------------------------------------

class StandardScaler:
    def __init__(self) -> None:
        self.mean_: np.ndarray | None = None
        self.scale_: np.ndarray | None = None

    def fit(self, X: np.ndarray) -> "StandardScaler":
        X = np.asarray(X, dtype=np.float64)
        self.mean_ = X.mean(axis=0)
        std = X.std(axis=0)
        self.scale_ = np.where(std > 1e-12, std, 1.0)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (np.asarray(X, dtype=np.float64) - self.mean_) / self.scale_

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)

    def get_state(self) -> dict:
        return {"mean": self.mean_, "scale": self.scale_}

    def set_state(self, s: dict) -> None:
        self.mean_ = np.asarray(s["mean"], dtype=np.float64)
        self.scale_ = np.asarray(s["scale"], dtype=np.float64)


# ---------------------------------------------------------------------------
# Correlation pruning
# ---------------------------------------------------------------------------

class CorrelationPruner:
    """Drop features with pairwise |ρ| above ``threshold`` (paper: 80%).

    For each correlated pair, the paper removes the member with the larger
    *total* correlation with all other features — reproduced exactly.
    """

    def __init__(self, threshold: float = 0.8) -> None:
        self.threshold = threshold
        self.keep_: np.ndarray | None = None

    def fit(self, X: np.ndarray) -> "CorrelationPruner":
        X = np.asarray(X, dtype=np.float64)
        d = X.shape[1]
        std = X.std(axis=0)
        safe = np.where(std > 1e-12, std, 1.0)
        Z = (X - X.mean(axis=0)) / safe
        corr = np.abs(Z.T @ Z / max(X.shape[0], 1))
        corr[np.arange(d), np.arange(d)] = 0.0
        # constant features carry no information: drop them outright
        alive = std > 1e-12
        total = corr.sum(axis=1)
        # iteratively remove worst offender of the highest-correlation pair
        while True:
            masked = corr * np.outer(alive, alive)
            i, j = np.unravel_index(np.argmax(masked), masked.shape)
            if masked[i, j] <= self.threshold:
                break
            drop = i if total[i] >= total[j] else j
            alive[drop] = False
        self.keep_ = np.flatnonzero(alive)
        if self.keep_.size == 0:   # degenerate guard: keep at least one feature
            self.keep_ = np.array([0])
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, dtype=np.float64)[:, self.keep_]

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)

    def get_state(self) -> dict:
        return {"threshold": self.threshold, "keep": self.keep_}

    def set_state(self, s: dict) -> None:
        self.threshold = float(s["threshold"])
        self.keep_ = np.asarray(s["keep"], dtype=np.int64)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

class PreprocessPipeline:
    """Yeo-Johnson → standardize → corr-prune, exactly as paper §IV-C."""

    def __init__(self, corr_threshold: float = 0.8,
                 use_yeo_johnson: bool = True) -> None:
        self.use_yeo_johnson = use_yeo_johnson
        self.yj = YeoJohnsonTransformer()
        self.scaler = StandardScaler()
        self.pruner = CorrelationPruner(corr_threshold)

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        Z = self.yj.fit_transform(X) if self.use_yeo_johnson else np.asarray(
            X, dtype=np.float64)
        Z = self.scaler.fit_transform(Z)
        return self.pruner.fit_transform(Z)

    def transform(self, X: np.ndarray) -> np.ndarray:
        Z = self.yj.transform(X) if self.use_yeo_johnson else np.asarray(
            X, dtype=np.float64)
        Z = self.scaler.transform(Z)
        return self.pruner.transform(Z)

    def fused_params(self) -> tuple:
        """Everything the compiled fast path needs, pre-restricted to the
        columns that survive the correlation prune:
        ``(keep_idx, lambdas_kept | None, mean_kept, scale_kept)``.

        The three stages are elementwise per column, so transforming only
        the kept columns with these sliced parameters is bit-identical to
        ``transform()`` followed by the prune's column selection.
        """
        if self.pruner.keep_ is None or self.scaler.mean_ is None:
            raise ValueError("pipeline not fitted")
        keep = np.asarray(self.pruner.keep_, dtype=np.int64)
        lam = self.yj.lambdas_[keep] if self.use_yeo_johnson else None
        return keep, lam, self.scaler.mean_[keep], self.scaler.scale_[keep]

    def get_state(self) -> dict:
        return {
            "use_yj": self.use_yeo_johnson,
            "yj": self.yj.get_state(),
            "scaler": self.scaler.get_state(),
            "pruner": self.pruner.get_state(),
        }

    def set_state(self, s: dict) -> None:
        self.use_yeo_johnson = bool(s["use_yj"])
        self.yj.set_state(s["yj"])
        self.scaler.set_state(s["scaler"])
        self.pruner.set_state(s["pruner"])
