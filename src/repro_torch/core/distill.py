"""Beyond-paper: ensemble → single-tree distillation for fast runtime eval.

Paper Table VI shows the accuracy/eval-latency trade-off killing the best
models (RandomForest: best RMSE, 983 µs eval → loses on estimated speedup).
We attack t_eval directly: fit the strongest ensemble, then distill it into
ONE array-tree by fitting the ensemble's *predictions* on an augmented
sample of the feature space.  Eval cost drops to a single tree descent
(~DecisionTree latency) while keeping most of the ensemble's shape.

``distill()`` returns an Estimator usable anywhere a candidate model is —
the selection machinery (estimated speedup) decides per-subroutine whether
the distilled model wins, exactly in the paper's spirit.
"""

from __future__ import annotations

import numpy as np

from .ml import make_model, register
from .ml.base import Estimator
from .ml.tree import ArrayTree


@register
class DistilledTree(Estimator):
    """Single tree fit to a teacher ensemble's predictions."""
    NAME = "DistilledTree"
    PARAM_GRID = {"max_depth": [10, 14], "augment": [3]}

    def __init__(self, teacher: str = "XGBoost", max_depth: int = 12,
                 augment: int = 3, seed: int = 0) -> None:
        self.teacher = teacher
        self.max_depth = max_depth
        self.augment = augment
        self.seed = seed
        self.tree_ = ArrayTree()

    @property
    def trees_(self) -> tuple:
        """Uniform tree-model interface: a distilled model is a single-tree
        ensemble, so the compiled decision engine's predicated lowering
        (see :mod:`repro_torch.core.fastpath`) applies unchanged."""
        return (self.tree_,)

    def fit(self, X, y):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        teacher = make_model(self.teacher).fit(X, y)
        rng = np.random.default_rng(self.seed)
        # augment: jitter real samples so the tree sees the teacher's
        # interpolation behaviour, not just the training points
        Xs = [X]
        scale = X.std(axis=0, keepdims=True) * 0.05 + 1e-12
        for _ in range(self.augment):
            Xs.append(X + rng.normal(scale=scale, size=X.shape))
        Xa = np.concatenate(Xs, axis=0)
        ya = teacher.predict(Xa)
        self.tree_.build(Xa, ya, np.ones(len(ya)), max_depth=self.max_depth,
                         min_samples_leaf=2, max_features=None, rng=rng)
        return self

    def predict(self, X):
        return self.tree_.predict(np.asarray(X, dtype=np.float64))

    def get_state(self):
        return {"tree": self.tree_.get_state(), "max_depth": self.max_depth,
                "teacher": self.teacher, "augment": self.augment}

    def set_state(self, s):
        self.tree_.set_state(s["tree"])
        self.max_depth = int(s["max_depth"])
        self.teacher = str(s["teacher"])
        self.augment = int(s["augment"])
