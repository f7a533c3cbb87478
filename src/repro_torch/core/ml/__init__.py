"""From-scratch numpy ML library implementing the paper's 8 candidate models
(Table II/VI): LinearRegression, ElasticNet, BayesianRidge, DecisionTree,
RandomForest, AdaBoost, XGBoost, KNN (+ Ridge as a utility)."""

from .base import Estimator, MODEL_REGISTRY, make_model, register
from .linear import LinearRegression, Ridge, ElasticNet, BayesianRidge
from .tree import DecisionTree, ArrayTree
from .forest import RandomForest, AdaBoost
from .boosting import XGBoost
from .knn import KNN
from .metrics import rmse, normalized_rmse, r2, cross_val_rmse
from .tuning import tune_model

#: Candidate set compared in paper Table VI (SVM excluded — see DESIGN.md §2).
PAPER_CANDIDATES = (
    "LinearRegression", "ElasticNet", "BayesianRidge", "DecisionTree",
    "RandomForest", "AdaBoost", "XGBoost", "KNN",
)

__all__ = [
    "Estimator", "MODEL_REGISTRY", "make_model", "register",
    "LinearRegression", "Ridge", "ElasticNet", "BayesianRidge",
    "DecisionTree", "ArrayTree", "RandomForest", "AdaBoost", "XGBoost", "KNN",
    "rmse", "normalized_rmse", "r2", "cross_val_rmse", "tune_model",
    "PAPER_CANDIDATES",
]
