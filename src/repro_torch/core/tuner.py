"""End-to-end install-time tuning pipeline for one BLAS L3 subroutine
(paper Fig. 1a):

    Halton sampling → timing sweep → Table-III features → LOF outlier removal
    → Yeo-Johnson + standardize + corr-prune → stratified split → per-model
    hyper-parameter tuning → estimated-speedup model selection → persist.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from . import features as F
from .dataset import TimingDataset, gather
from .knobs import Knob, KnobSpace
from .lof import remove_outliers
from .ml import PAPER_CANDIDATES
from .preprocess import PreprocessPipeline
from .selection import ModelReport, evaluate_candidates, select_best
from .split import stratified_split

__all__ = ["TunedSubroutine", "install_subroutine", "install_backend",
           "attach_knn_coreset"]

#: persisted artifact schema (the reference package's): v1 = single-backend,
#: v2 = backend-tagged
SCHEMA_VERSION = 2


@dataclasses.dataclass
class TunedSubroutine:
    """The production artifact: everything runtime needs for one subroutine."""
    op: str
    dtype_bytes: int
    knob_space: KnobSpace
    pipeline: PreprocessPipeline
    model: object                       # fitted Estimator
    model_name: str
    log_target: bool
    reports: list[ModelReport] = dataclasses.field(default_factory=list)
    dataset: TimingDataset | None = None
    backend: str = "hopper"             # execution backend this was tuned on
    #: monotonically increasing per-artifact generation, stamped by
    #: :meth:`~repro_torch.core.registry.ModelRegistry.save` (0 = never persisted
    #: through a registry / pre-versioning artifact).  The runtime persists
    #: it with every decision-cache entry so a warm restart can reject
    #: decisions made by a different generation of this model instead of
    #: silently replaying a predecessor's knobs.
    artifact_version: int = 0
    #: dominated-candidate analysis for the compiled fast path (optional,
    #: persisted): knob indices the model ever argmin-selects over the
    #: install dataset's dims, and that dataset's dims bounding box
    fast_live_idx: np.ndarray | None = None
    fast_dims_lo: np.ndarray | None = None
    fast_dims_hi: np.ndarray | None = None
    #: confidence-band variant of the live set (optional, persisted): knob
    #: indices whose predicted time ever comes within ``fast_band_pct`` % of
    #: the per-dims winner over the install dataset — a superset of
    #: ``fast_live_idx`` that tolerates interpolation wobble
    fast_band_idx: np.ndarray | None = None
    fast_band_pct: float | None = None
    #: opt-in KNN coreset (optional, persisted): indices into the fitted
    #: KNN's training set for the inexact-but-faster compiled lookup
    fast_knn_coreset: np.ndarray | None = None
    #: what timed the install's labels (optional, persisted), e.g.
    #: ``"oracle"`` for a rehearsal against ``core/oracle.py`` that never
    #: ran on a card, or ``"wallclock NVIDIA H100 80GB HBM3"``
    timer: str | None = None

    # -- runtime decision --------------------------------------------------
    def predict_times(self, dims: tuple[int, ...]) -> np.ndarray:
        """Predicted runtime for every knob candidate at these dims.

        This is the REFERENCE decision path: the runtime serves decisions
        through :meth:`compiled` (bit-identical argmin, far lower latency)
        and parity tests compare the two."""
        K = len(self.knob_space)
        X = F.build_features(self.op, np.tile(np.array(dims), (K, 1)),
                             self.knob_space.parallelism_vec(dims))
        pred = self.model.predict(self.pipeline.transform(X))
        return np.exp(pred) if self.log_target else pred

    def select(self, dims: tuple[int, ...]) -> Knob:
        return self.knob_space.candidates[int(np.argmin(self.predict_times(dims)))]

    def compiled(self, *, prune=False, coreset: bool = False):
        """The cached :class:`~repro_torch.core.fastpath.CompiledPredictor` for
        this artifact (None when uncompilable).  ``prune`` may be ``False``,
        ``True`` (argmin live set) or ``"band"`` (confidence-band live
        set); ``coreset=True`` opts a KNN artifact into its persisted
        subsample."""
        cache = getattr(self, "_compiled_cache", None)
        if cache is None:
            cache = self._compiled_cache = {}
        key = (prune, coreset)
        if key not in cache:
            from .fastpath import compile_predictor
            cache[key] = compile_predictor(self, prune=prune,
                                           coreset=coreset)
        return cache[key]

    # -- persistence ---------------------------------------------------------
    def get_state(self) -> dict:
        state = {
            "version": SCHEMA_VERSION,
            "backend": self.backend,
            "op": self.op,
            "dtype_bytes": self.dtype_bytes,
            "knobs": self.knob_space.get_state(),
            "pipeline": self.pipeline.get_state(),
            "model_name": self.model_name,
            "model": self.model.get_state(),
            "log_target": self.log_target,
            "reports": [r.row() for r in self.reports],
        }
        # optional keys: absent on pre-fast-path artifacts, ignored by
        # older readers — no schema bump needed
        if self.artifact_version:
            state["artifact_version"] = int(self.artifact_version)
        if self.fast_live_idx is not None:
            state["fast_live_idx"] = np.asarray(self.fast_live_idx,
                                                dtype=np.int64)
            state["fast_dims_lo"] = np.asarray(self.fast_dims_lo,
                                               dtype=np.int64)
            state["fast_dims_hi"] = np.asarray(self.fast_dims_hi,
                                               dtype=np.int64)
        if self.fast_band_idx is not None:
            state["fast_band_idx"] = np.asarray(self.fast_band_idx,
                                                dtype=np.int64)
            state["fast_band_pct"] = float(self.fast_band_pct)
        if self.fast_knn_coreset is not None:
            state["fast_knn_coreset"] = np.asarray(self.fast_knn_coreset,
                                                   dtype=np.int64)
        if self.timer is not None:
            state["timer"] = str(self.timer)
        return state


def install_subroutine(
    op: str,
    knob_space: KnobSpace,
    timer_fn: Callable[[tuple[int, ...], Knob], float],
    *,
    n_samples: int = 200,
    dim_lo: int = 16,
    dim_hi: int = 1024,
    max_footprint_bytes: int | None = 32 * 1024 * 1024,
    dtype_bytes: int = 4,
    candidates: Sequence[str] = PAPER_CANDIDATES,
    log_target: bool = True,
    use_lof: bool = True,
    use_yeo_johnson: bool = True,
    tune_trials: int = 6,
    test_frac: float = 0.15,
    seed: int = 0,
    dataset: TimingDataset | None = None,
    keep_dataset: bool = True,
    progress: Callable[[int, int], None] | None = None,
    backend: str = "hopper",
    band_pct: float = 10.0,
    knn_coreset_frac: float | None = None,
) -> TunedSubroutine:
    """Run the full ADSALA install for one subroutine; returns the artifact."""
    ds = dataset if dataset is not None else gather(
        op, knob_space, timer_fn, n_samples=n_samples, dim_lo=dim_lo,
        dim_hi=dim_hi, max_footprint_bytes=max_footprint_bytes,
        dtype_bytes=dtype_bytes, seed=seed, progress=progress)

    # stratify samples on their best measured time so slow/fast regimes are
    # represented in both splits (paper: stratified sampling, 15% test)
    best_t = ds.times.min(axis=1)
    train_s, test_s = stratified_split(np.log(np.maximum(best_t, 1e-12)),
                                       test_frac=test_frac, seed=seed)

    # LOF outlier removal on the flattened training rows (features ∪ label)
    lof_keep = None
    if use_lof:
        X_all, y_all, sample_idx = ds.flatten()
        in_train = np.isin(sample_idx, train_s)
        y_log = np.log(np.maximum(y_all, 1e-12))
        _, _, keep_sub = remove_outliers(X_all[in_train], y_log[in_train])
        lof_keep = np.ones(X_all.shape[0], dtype=bool)
        lof_keep[np.flatnonzero(in_train)] = keep_sub

    pipeline = PreprocessPipeline(use_yeo_johnson=use_yeo_johnson)
    reports = evaluate_candidates(
        ds, pipeline, train_s, test_s, candidates=candidates,
        log_target=log_target, tune_trials=tune_trials, seed=seed,
        lof_keep_mask=lof_keep)
    best = select_best(reports)
    sub = TunedSubroutine(
        op=op, dtype_bytes=dtype_bytes, knob_space=knob_space,
        pipeline=pipeline, model=best.model, model_name=best.name,
        log_target=log_target, reports=reports,
        dataset=ds if keep_dataset else None, backend=backend)
    _analyze_dominated(sub, ds, band_pct=band_pct)
    if knn_coreset_frac is not None:
        attach_knn_coreset(sub, frac=knn_coreset_frac, seed=seed)
    return sub


def _analyze_dominated(sub: TunedSubroutine, ds: TimingDataset,
                       chunk: int = 32, band_pct: float = 10.0) -> None:
    """Record which knob candidates the selected model ever argmin-picks
    over the gathered dims (plus the dims bounding box) on the artifact, so
    the compiled fast path can optionally drop the dominated candidates
    (``prune=True``) inside the regime that validated the drop.

    Additionally records the confidence-band live set: candidates whose
    predicted time ever comes within ``band_pct`` % of the per-dims winner.
    A candidate outside the band on EVERY install dims is dominated with
    margin — dropping it is robust to the interpolation wobble that makes
    the argmin-only set brittle — while near-winners survive, so
    ``prune="band"`` trades less latency for more safety."""
    cp = sub.compiled()
    if cp is None or ds.n_samples == 0:
        return
    chosen: list[np.ndarray] = []
    K = len(sub.knob_space)
    ratio_min = np.full(K, np.inf)
    for i in range(0, ds.n_samples, chunk):     # chunked: bounds KNN memory
        dims_list = [tuple(int(v) for v in d) for d in ds.dims[i:i + chunk]]
        t = cp.predict_times_batch(dims_list)
        chosen.append(np.argmin(t, axis=1))
        # per-candidate closest approach to the winner in this chunk
        ratio = t / np.maximum(t.min(axis=1, keepdims=True), 1e-300)
        np.minimum(ratio_min, ratio.min(axis=0), out=ratio_min)
    sub.fast_live_idx = np.unique(np.concatenate(chosen)).astype(np.int64)
    sub.fast_dims_lo = ds.dims.min(axis=0).astype(np.int64)
    sub.fast_dims_hi = ds.dims.max(axis=0).astype(np.int64)
    sub.fast_band_idx = np.flatnonzero(
        ratio_min <= 1.0 + band_pct / 100.0).astype(np.int64)
    sub.fast_band_pct = float(band_pct)


def attach_knn_coreset(sub: TunedSubroutine, *, frac: float = 0.25,
                       min_size: int = 64, seed: int = 0) -> bool:
    """Persist an opt-in coreset subsample on a KNN artifact.

    The subsample is stratified over the fitted targets (equal-count y
    quantiles, uniform within each), so fast/slow timing regimes stay
    represented.  The compiled fast path only consults it under
    ``coreset=True`` — default decisions are unchanged.  Returns False for
    non-KNN models (nothing to attach)."""
    model = sub.model
    if getattr(model, "NAME", None) != "KNN" or model.X_ is None:
        return False
    n = model.X_.shape[0]
    size = int(np.clip(round(frac * n), min(min_size, n), n))
    if size >= n:
        sub.fast_knn_coreset = np.arange(n, dtype=np.int64)
        return True
    rng = np.random.default_rng(seed)
    strata = max(1, size // 8)
    order = np.argsort(model.y_, kind="stable")
    picks: list[np.ndarray] = []
    for part, quota in zip(np.array_split(order, strata),
                           np.array_split(np.arange(size), strata)):
        take = min(len(quota), part.size)
        picks.append(rng.choice(part, size=take, replace=False))
    sub.fast_knn_coreset = np.sort(np.concatenate(picks)).astype(np.int64)
    return True


def install_backend(
    backend,                            # repro_torch.backends.Backend
    *,
    ops: Sequence[str] | None = None,
    dtype=None,
    sizes: Sequence[int] | None = None,
    runtime=None,                       # AdsalaRuntime to register into
    registry=None,                      # ModelRegistry to persist into
    log: Callable[[str], None] | None = None,
    **install_kw,
) -> dict[str, TunedSubroutine]:
    """Sweep all (or selected) ops of one execution backend in one call.

    The backend supplies its own knob space and calibration timer, so the
    identical install pipeline runs against any registered implementation —
    the repo analogue of installing ADSALA on MKL and then on BLIS.  Tuned
    artifacts are optionally registered into a live runtime and persisted
    backend-tagged through a :class:`~repro_torch.core.registry.ModelRegistry`.
    """
    dtype = np.float32 if dtype is None else dtype
    dtype_bytes = int(np.dtype(dtype).itemsize)
    out: dict[str, TunedSubroutine] = {}
    for op in (tuple(ops) if ops else backend.ops()):
        space = (backend.knob_space(op, sizes=tuple(sizes)) if sizes
                 else backend.knob_space(op))
        timer = backend.timer_fn(op, dtype)
        sub = install_subroutine(op, space, timer, dtype_bytes=dtype_bytes,
                                 backend=backend.name, **install_kw)
        if registry is not None:
            registry.save(sub)
        if runtime is not None:
            runtime.register(sub)
        out[op] = sub
        if log is not None:
            log(f"[install_backend] {backend.name}/{op}: "
                f"best={sub.model_name} over {len(space)} knobs")
    return out
