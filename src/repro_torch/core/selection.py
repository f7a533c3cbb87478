"""Model evaluation + automatic model selection (paper §IV-D, Table VI).

Selection metric is the *estimated speedup*

    s = t_original / (t_ADSALA + t_eval)

where ``t_original`` is the measured runtime at the default (max-parallelism)
config, ``t_ADSALA`` the measured runtime at the model's argmin-predicted
config, and ``t_eval`` the measured model evaluation latency for one BLAS
call (a batch predict over all knob candidates).  The model with the highest
estimated mean speedup wins — predictive accuracy and evaluation speed trade
off exactly as in the paper.

``t_eval`` is measured through the COMPILED fast path
(:class:`~repro_torch.core.fastpath.CompiledPredictor`) — the path the production
runtime actually serves decisions from — so the metric charges each model
its real per-call cost, not the slower reference pipeline's.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Sequence

import numpy as np

from .dataset import TimingDataset
from .fastpath import CompiledPredictor, compile_predictor
from .ml import make_model, tune_model, rmse
from .preprocess import PreprocessPipeline

__all__ = ["ModelReport", "evaluate_candidates", "select_best"]


@dataclasses.dataclass
class ModelReport:
    name: str
    test_rmse: float
    normalized_rmse: float
    ideal_mean_speedup: float
    ideal_aggregate_speedup: float
    eval_time_us: float
    estimated_mean_speedup: float
    estimated_aggregate_speedup: float
    fit_seconds: float
    model: object = None  # the fitted Estimator

    def row(self) -> dict:
        return {k: getattr(self, k) for k in (
            "name", "normalized_rmse", "ideal_mean_speedup",
            "ideal_aggregate_speedup", "eval_time_us",
            "estimated_mean_speedup", "estimated_aggregate_speedup")}


def _measure_eval_time_us(compiled: CompiledPredictor,
                          dims: tuple[int, ...], *, repeats: int = 50
                          ) -> float:
    """Latency of one runtime decision through the compiled fast path —
    fused feature build + transform + predict + argmin over all knobs."""
    compiled.select(dims)                # warmup (allocates thread buffers)
    t0 = time.perf_counter()
    for _ in range(repeats):
        compiled.select(dims)
    return (time.perf_counter() - t0) / repeats * 1e6


def _measure_reference_eval_time_us(ds: TimingDataset,
                                    pipeline: PreprocessPipeline, model,
                                    dims: tuple[int, ...], *,
                                    repeats: int = 50) -> float:
    """Fallback when the fast path can't compile for this (space, model):
    time the reference transform + predict the runtime would serve."""
    from . import features as F
    K = len(ds.knob_space)
    X_one = F.build_features(ds.op, np.tile(np.array(dims), (K, 1)),
                             ds.knob_space.parallelism_vec(dims))
    model.predict(pipeline.transform(X_one))
    t0 = time.perf_counter()
    for _ in range(repeats):
        model.predict(pipeline.transform(X_one))
    return (time.perf_counter() - t0) / repeats * 1e6


def _speedups(times: np.ndarray, default_idx: int, chosen: np.ndarray,
              t_eval_s: float) -> tuple[float, float, float, float]:
    """(ideal_mean, ideal_agg, est_mean, est_agg) over test samples."""
    t_orig = times[:, default_idx]
    t_chosen = times[np.arange(times.shape[0]), chosen]
    ideal_mean = float(np.mean(t_orig / np.maximum(t_chosen, 1e-12)))
    ideal_agg = float(t_orig.sum() / max(t_chosen.sum(), 1e-12))
    est = t_chosen + t_eval_s
    est_mean = float(np.mean(t_orig / np.maximum(est, 1e-12)))
    est_agg = float(t_orig.sum() / max(est.sum(), 1e-12))
    return ideal_mean, ideal_agg, est_mean, est_agg


def evaluate_candidates(
    ds: TimingDataset,
    pipeline: PreprocessPipeline,
    train_sample_idx: np.ndarray,
    test_sample_idx: np.ndarray,
    *,
    candidates: Sequence[str],
    log_target: bool = True,
    tune_trials: int = 6,
    seed: int = 0,
    lof_keep_mask: np.ndarray | None = None,
) -> list[ModelReport]:
    """Fit/tune every candidate on train samples, score on test samples."""
    X_all, y_all, sample_idx = ds.flatten()
    y_fit = np.log(np.maximum(y_all, 1e-12)) if log_target else y_all

    in_train = np.isin(sample_idx, train_sample_idx)
    if lof_keep_mask is not None:
        in_train &= lof_keep_mask
    in_test = np.isin(sample_idx, test_sample_idx)

    Z_train = pipeline.fit_transform(X_all[in_train])
    Z_test = pipeline.transform(X_all[in_test])
    ytr, yte = y_fit[in_train], y_fit[in_test]

    # per-test-sample knob prediction setup
    K = len(ds.knob_space)
    test_samples = np.asarray(test_sample_idx)
    default_idx = ds.default_knob_index()
    times_test = ds.times[test_samples]             # (T, K) measured

    # one representative runtime call's dims (eval-time measurement)
    d0 = tuple(int(v) for v in ds.dims[test_samples[0]])

    # baseline RMSE for normalisation = worst linear-family candidate
    reports: list[ModelReport] = []
    for name in candidates:
        t0 = time.perf_counter()
        model = tune_model(make_model(name), Z_train, ytr,
                           n_trials=tune_trials, seed=seed)
        fit_s = time.perf_counter() - t0
        test_rmse = rmse(yte, model.predict(Z_test))
        # the exact artifact-compilation entry point the runtime uses, so
        # t_eval is charged at the lowering each family actually serves
        # (returns None for uncompilable combinations)
        compiled = compile_predictor(types.SimpleNamespace(
            op=ds.op, knob_space=ds.knob_space, pipeline=pipeline,
            model=model, log_target=log_target))
        if compiled is not None:
            t_eval_us = _measure_eval_time_us(compiled, d0)
        else:
            t_eval_us = _measure_reference_eval_time_us(
                ds, pipeline, model, d0)
        # argmin-predicted knob per test sample
        pred = model.predict(Z_test).reshape(len(test_samples), K)
        chosen = np.argmin(pred, axis=1)
        im, ia, em, ea = _speedups(times_test, default_idx, chosen,
                                   t_eval_us * 1e-6)
        reports.append(ModelReport(
            name=name, test_rmse=test_rmse, normalized_rmse=np.nan,
            ideal_mean_speedup=im, ideal_aggregate_speedup=ia,
            eval_time_us=t_eval_us, estimated_mean_speedup=em,
            estimated_aggregate_speedup=ea, fit_seconds=fit_s, model=model))

    # normalise RMSE by the worst candidate's RMSE (paper Table VI: linear
    # models sit at 1.00)
    worst = max(r.test_rmse for r in reports) or 1.0
    for r in reports:
        r.normalized_rmse = r.test_rmse / worst
    return reports


def select_best(reports: list[ModelReport]) -> ModelReport:
    """Paper IV-D: highest estimated mean speedup wins."""
    return max(reports, key=lambda r: r.estimated_mean_speedup)
