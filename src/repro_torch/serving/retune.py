"""Online feedback loop: drift-aware retuning from serving telemetry (the
reference package's ``serving/retune.py`` on the port's runtime).

The install-time pipeline (paper Fig. 1a) freezes its models against a
calibration sweep taken once, on one machine state.  A serving process sees
traffic and machine conditions *drift* away from that sweep — co-tenancy,
thermal throttling, allocator fragmentation, a traffic mix the Halton
samples never covered — and the paper's own premise ("predictions are only
as good as the measurements behind them", after Xia & Barnard's GEMM
feedback loop) then cuts against the frozen artifact.  Serving already
measures ground truth: every stacked bucket execution records its
execution time in :class:`~repro_torch.core.runtime.BucketStats`.  This
module closes the loop::

    BucketStats deltas ──► (dims, chosen knob, measured s/item) samples
         │                        │
         │ per (backend, op, dtype) shard
         ▼                        ▼
    EWMA of |ratio / anchor − 1|, ratio = measured / predicted  (drift signal)
         │ > drift_threshold for ≥ min_samples
         ▼
    blended install ∪ telemetry dataset ──► refit (same install pipeline)
         ▼
    ModelRegistry.save (version bump) ──► AdsalaRuntime.swap (atomic)

What is measured
    On the card both sides of the comparison are the kernels' device time:
    the install's labels (``core/timing.py``) and a probed bucket's
    execution time (``serving/service.py``) are each taken with
    ``kernels/introspect.py::launch_window``: a pair of CUDA events each
    kernel launcher records around its launch within one C call.  The
    host's dispatch ahead of the launch and a worker's waits for the GIL
    stay out of both.
    A label is one call of one item; a bucket is a stack of b items in
    one launch, which on the card takes anything from one call's time
    (where one item leaves SMs idle) to b calls' time.  So the service
    probes: once per key and step (:meth:`Retuner.claim_probe`) it runs a
    bucket's first item alone, with the card to itself, as the install's
    timer does: a warm-up call, then three timed calls, whose median it
    books as the bucket's execution of one item; the other buckets book
    none.  One timed call alone would let a host held up between a
    launch's events read as drift.

Drift signal
    Each telemetry sample compares the measured per-item execution time of
    a bucket with the *registered predictor's* prediction for the knob
    that was actually chosen (the decision cache's knob for that key).
    On the card an installed model's error at one served point is large
    and standing: a linear family misses a (512, 512, 512) GEMM by 5x, and
    the features see a knob only through its CTA count, so knobs that
    differ in ``bk`` alone share one prediction.  Measured against the
    prediction itself, steady traffic would read as drift.  So each
    ``(dims, knob)`` first *anchors* its ratio measured/predicted — the
    median of its first ``anchor_samples`` samples, the model's own
    standing error there — and drift is the relative change of that ratio
    from its anchor: ``|ratio / anchor - 1|``.  ``anchor_samples=0`` gives
    the reference's signal, ``|measured - predicted| / predicted`` from
    the first sample.  The relative error feeds an exponentially weighted
    moving average per ``(backend, op, dtype_bytes)`` subroutine; crossing
    ``drift_threshold`` with at least ``min_samples`` observations
    triggers a retune of that subroutine only.  What the anchor gives up:
    a model that is wrong at a served point from its first sample is not
    refit for it (:meth:`Retuner.anchors` reports that standing error).

Blending
    Serving telemetry is exploitation-only — it measures the *chosen* knob
    at the *served* dims, never the alternatives.  The blend therefore
    builds full candidate rows: for each telemetry sample, the predicted
    times of every knob with the measured knob's column overwritten by the
    measurement (replicated ``telemetry_repeat``× so traffic outweighs the
    stale sweep where they conflict).  With ``correct_install`` (default),
    the install rows' columns for measured knobs are additionally rescaled
    by the EWMA measured/predicted ratio — the drift observed on served
    dims extends to the rest of the knob's calibration column, which is
    what lets a *global* timing shift (the common case: the whole backend
    got slower for one block shape) flip decisions outside the served
    region too.  LOF outlier removal is OFF during refits: drifted
    measurements are exactly the points LOF would discard.

Swap semantics
    The refit subroutine is recompiled through the same
    :func:`~repro_torch.core.fastpath.compile_predictor` used at artifact load,
    persisted through the registry (stamping the next monotonically
    increasing ``artifact_version``), and hot-swapped with
    :meth:`AdsalaRuntime.swap`: in-flight selects finish on the old
    predictor, new selects see the new one, and the subroutine's
    decision-cache entries are invalidated in the same critical section —
    post-swap decisions are bit-identical to a fresh process loading the
    new artifact.

Reproducibility
    The loop is opt-in.  A reproduction run that must serve the paper's
    frozen artifacts simply never constructs a :class:`Retuner` (or passes
    ``retuner=None`` to :class:`~repro_torch.serving.BlasService`, the default);
    ``Retuner.stop()`` also halts a live loop at any point.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.core.dataset import TimingDataset
from repro_torch.core.runtime import DEFAULT_BACKEND, AdsalaRuntime
from repro_torch.core.tuner import install_subroutine

__all__ = ["Retuner", "RetuneConfig", "RetuneStats"]


@dataclasses.dataclass(frozen=True)
class RetuneConfig:
    """Knobs of the online feedback loop."""
    ewma_alpha: float = 0.25       # weight of the newest relative error
    drift_threshold: float = 0.5   # EWMA rel. error that triggers a retune
    min_samples: int = 8           # per-subroutine floor before triggering
    #: samples of one (dims, knob) whose median ratio measured/predicted
    #: anchors its drift signal (module docstring); 0 = the reference's
    #: signal, the error against the prediction itself
    anchor_samples: int = 3
    telemetry_cap: int = 512       # ring-buffer cap per subroutine
    telemetry_repeat: int = 4      # replication of telemetry rows in blend
    correct_install: bool = True   # rescale install rows of measured knobs
    interval_s: float = 2.0        # background poll period
    #: model families to refit over (None = the artifact's own family —
    #: keeps the refit cheap and the decision surface comparable)
    candidates: Optional[tuple] = None
    tune_trials: int = 2           # hyper-parameter trials per refit
    use_lof: bool = False          # see module docstring: LOF eats drift
    seed: int = 0                  # deterministic refits
    #: per-step probability of overriding ONE served bucket's cached
    #: decision with a random non-argmin, non-quarantined knob for a single
    #: step — serving telemetry is exploitation-only, so without occasional
    #: exploration a refit blend never gets a *measured* row for the
    #: columns the argmin policy skips, and ``correct_install`` has nothing
    #: to anchor them on.  0 (the default) disables exploration — the
    #: reproducibility posture, like the retuner itself.
    explore_epsilon: float = 0.0

    def __post_init__(self) -> None:
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.drift_threshold <= 0:
            raise ValueError("drift_threshold must be > 0")
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        if self.anchor_samples < 0:
            raise ValueError("anchor_samples must be >= 0")
        if self.telemetry_cap < 1 or self.telemetry_repeat < 1:
            raise ValueError("telemetry_cap/telemetry_repeat must be >= 1")
        if not 0.0 <= self.explore_epsilon < 1.0:
            raise ValueError("explore_epsilon must be in [0, 1)")


@dataclasses.dataclass
class RetuneStats:
    samples: int = 0            # telemetry samples ingested
    skipped: int = 0            # bucket deltas with no usable signal
    drift_events: int = 0       # threshold crossings observed by step()
    retunes: int = 0            # successful refit + swap cycles
    swap_invalidations: int = 0  # decision-cache entries invalidated
    errors: int = 0
    last_error: Optional[str] = None
    observe_failures: int = 0   # telemetry-ingestion raises (survived)
    refit_failures: int = 0     # retune raises (survived; backoff applied)
    explorations: int = 0       # epsilon decision-cache overrides served
    abandoned_stops: int = 0    # stop() joins that timed out mid-refit
                                # (thread kept halted, never nulled alive)


class _SubState:
    """Per-``(backend, op, dtype_bytes)`` drift/telemetry accumulator."""
    __slots__ = ("ewma", "n", "knob_ratio", "samples", "cap", "anchors")

    def __init__(self, cap: int) -> None:
        self.ewma: float | None = None
        self.n = 0
        #: knob index -> EWMA of measured/predicted (the per-knob drift
        #: correction the blend applies to install rows)
        self.knob_ratio: dict[int, float] = {}
        #: (dims, knob index) -> latest measured seconds/item, newest last.
        #: Keyed, not appended: a re-measured bucket REPLACES its old
        #: sample — after a drift, the pre-drift measurement of the same
        #: bucket is exactly the contradictory supervision that would pull
        #: the refit halfway back to the stale surface.
        self.samples: collections.OrderedDict = collections.OrderedDict()
        self.cap = cap
        #: (dims, knob index) -> the ratios measured/predicted seen so far
        #: (a list, while the anchor forms), then their median (a float)
        self.anchors: dict[tuple, list | float] = {}

    def put(self, dims: tuple, idx: int, measured: float) -> None:
        k = (dims, idx)
        self.samples.pop(k, None)           # re-insert at the fresh end
        self.samples[k] = measured
        while len(self.samples) > self.cap:
            self.samples.popitem(last=False)


class Retuner:
    """Background retrainer closing the serving→install feedback loop.

    Drive it manually (``observe()`` / ``step()`` — deterministic, used by
    tests and the bench) or as a thread (``start()`` / ``stop()`` — what
    :class:`~repro_torch.serving.BlasService` does when given a retuner).

    The loop only ever *reads* public runtime state (``stats.buckets``,
    ``peek``, ``predictor``, ``subroutine``) and mutates it through the
    atomic :meth:`AdsalaRuntime.swap` seam, so it is safe next to live
    serving traffic by construction.
    """

    def __init__(self, runtime: AdsalaRuntime, *, registry=None,
                 config: Optional[RetuneConfig] = None,
                 faults=None) -> None:
        self.runtime = runtime
        self.registry = registry
        self.config = config if config is not None else RetuneConfig()
        self.stats = RetuneStats()
        #: optional repro_torch.serving.faults.FaultPlan (chaos harness)
        self._faults = faults
        #: retune audit log: one dict per applied swap
        self.events: list[dict] = []
        self._state: dict[tuple, _SubState] = {}
        #: bucket key -> (exec_seconds, exec_items) already consumed
        self._seen: dict[tuple, tuple[float, int]] = {}
        #: active exploration overrides: bucket key -> served non-argmin knob
        self._exploring: dict[tuple, object] = {}
        self._explore_rng = random.Random(self.config.seed)
        self._lock = threading.Lock()       # observe/step vs stop
        self._step_lock = threading.Lock()  # the thread's step vs a caller's
        #: bucket keys a service has probed since the last observe()
        self._probed: set = set()
        self._probe_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._halt = threading.Event()

    # -- telemetry ingestion --------------------------------------------------
    def baseline(self) -> None:
        """Start the drift signal afresh at the runtime's current bucket
        totals: executions booked so far (a cold start's first launches,
        say) never become samples."""
        with self._lock:
            self._state.clear()
            self._seen = {key: (b.exec_seconds, b.exec_items)
                          for key, b in self.runtime.stats.buckets.items()}

    def claim_probe(self, key: tuple) -> bool:
        """True for the first caller asking for ``key`` (a bucket key)
        since the last :meth:`observe`: the service then probes that
        bucket (module docstring, "What is measured"), so telemetry costs
        one probe per key and step."""
        with self._probe_lock:
            if key in self._probed:
                return False
            self._probed.add(key)
            return True

    def observe(self) -> int:
        """Ingest new ``BucketStats`` execution deltas as telemetry samples;
        returns how many samples were added.

        A sample needs three things: a positive execution delta, the knob
        the decision cache currently holds for the bucket (``peek`` — a
        just-invalidated key contributes nothing until it is re-decided),
        and a finite positive prediction from the registered predictor."""
        if self._faults is not None:
            self._faults.fire("retuner_observe")
        added = 0
        snapshot = self.runtime.stats.buckets
        with self._probe_lock:
            self._probed.clear()
        with self._lock:
            for key, b in snapshot.items():
                prev_s, prev_i = self._seen.get(key, (0.0, 0))
                d_secs = b.exec_seconds - prev_s
                d_items = b.exec_items - prev_i
                if d_items <= 0 or d_secs <= 0.0:
                    continue
                self._seen[key] = (b.exec_seconds, b.exec_items)
                backend, op, dtype_bytes, dims = key
                sample = self._ingest(backend, op, dtype_bytes, dims,
                                      d_secs / d_items)
                if sample:
                    added += 1
                else:
                    self.stats.skipped += 1
        return added

    def _ingest(self, backend: str, op: str, dtype_bytes: int, dims: tuple,
                measured: float) -> bool:
        rt = self.runtime
        if not rt.has(op, dtype_bytes, backend):
            return False
        knob = rt.peek(op, dims, dtype_bytes, backend)
        if knob is None:
            return False
        sub = rt.subroutine(op, dtype_bytes, backend)
        space = getattr(sub, "knob_space", None)
        if space is None:
            return False
        try:
            idx = space.index(knob)
        except (KeyError, ValueError):
            return False            # knob from a space that no longer exists
        cp = rt.predictor(op, dtype_bytes, backend)
        try:
            times = cp.predict_times(dims) if cp is not None \
                else sub.predict_times(dims)
            predicted = float(times[idx])
        except Exception:           # noqa: BLE001 — stub/uncompilable model
            return False
        if not np.isfinite(predicted) or predicted <= 0.0:
            return False
        sub_key = (backend, op, dtype_bytes)
        st = self._state.get(sub_key)
        if st is None:
            st = self._state[sub_key] = _SubState(self.config.telemetry_cap)
        a = self.config.ewma_alpha
        ratio = measured / predicted
        prev = st.knob_ratio.get(idx)
        st.knob_ratio[idx] = ratio if prev is None \
            else a * ratio + (1.0 - a) * prev
        point = (tuple(int(d) for d in dims), idx)
        st.put(*point, float(measured))
        self.stats.samples += 1
        if self.config.anchor_samples:
            anchor = st.anchors.setdefault(point, [])
            if isinstance(anchor, list):
                anchor.append(ratio)
                if len(anchor) < self.config.anchor_samples:
                    return True         # the anchor is still forming
                anchor = st.anchors[point] = float(np.median(anchor))
            rel_err = abs(ratio / anchor - 1.0)
        else:
            rel_err = abs(measured - predicted) / predicted
        st.ewma = rel_err if st.ewma is None \
            else a * rel_err + (1.0 - a) * st.ewma
        st.n += 1
        return True

    def drift(self, op: str, dtype_bytes: int = 4,
              backend: str = DEFAULT_BACKEND) -> tuple[Optional[float], int]:
        """(EWMA relative error, sample count) for one subroutine; the
        count leaves out the samples that formed an anchor."""
        st = self._state.get((backend, op, dtype_bytes))
        return (None, 0) if st is None else (st.ewma, st.n)

    def anchors(self, op: str, dtype_bytes: int = 4,
                backend: str = DEFAULT_BACKEND) -> dict[tuple, float]:
        """The formed anchors of one subroutine: ``(dims, knob index) ->``
        the median ratio measured/predicted, the installed model's
        standing error at that served point."""
        st = self._state.get((backend, op, dtype_bytes))
        if st is None:
            return {}
        return {k: v for k, v in st.anchors.items()
                if not isinstance(v, list)}

    def drifted(self) -> list[tuple]:
        """Subroutine keys whose drift signal is over the trigger."""
        cfg = self.config
        return [k for k, st in self._state.items()
                if st.n >= cfg.min_samples and st.ewma is not None
                and st.ewma > cfg.drift_threshold]

    # -- the retune cycle -----------------------------------------------------
    def step(self) -> list[tuple]:
        """One feedback-loop iteration: ingest telemetry, retune every
        drifted subroutine, run the epsilon-exploration pass; returns the
        list of swapped subroutine keys.  Deterministic given the runtime's
        bucket state — the bench and the tests drive this directly.

        Every phase is individually fault-isolated: an observe raise leaves
        the drift state stale but the step alive (``observe_failures``), a
        refit raise is counted (``errors``/``refit_failures``) and the loop
        keeps serving the old model.  Steps run one at a time (the
        background thread's and a caller's)."""
        with self._step_lock:
            return self._step()

    def _step(self) -> list[tuple]:
        try:
            self.observe()
        except Exception as e:          # noqa: BLE001 — stale but alive
            self.stats.observe_failures += 1
            self.stats.last_error = f"{type(e).__name__}: {e}"
        swapped = []
        for sub_key in self.drifted():
            self.stats.drift_events += 1
            try:
                self.retune(sub_key)
                swapped.append(sub_key)
            except Exception as e:      # noqa: BLE001 — keep serving
                self.stats.errors += 1
                self.stats.refit_failures += 1
                self.stats.last_error = f"{type(e).__name__}: {e}"
        try:
            self._explore()
        except Exception as e:          # noqa: BLE001 — strictly optional
            self.stats.last_error = f"{type(e).__name__}: {e}"
        return swapped

    # -- bounded-epsilon exploration ------------------------------------------
    def _explore(self) -> int:
        """With probability ``explore_epsilon``, override ONE served
        bucket's cached decision with a random non-argmin knob for the
        coming step (restored — invalidated back to the model's choice — at
        the next call, after :meth:`observe` has ingested its measurement).

        Serving telemetry is exploitation-only: without this, a refit blend
        never sees a measured row for a column the argmin policy skips, and
        ``correct_install`` extrapolates those columns from nothing.
        Quarantined knobs are excluded — exploration must never re-serve a
        config that is currently benched for crashing."""
        eps = self.config.explore_epsilon
        if not eps:
            return 0
        rt = self.runtime
        # restore first: the observe() that preceded this call has already
        # ingested the explored knob's measurement
        for (backend, op, dtype_bytes, dims) in list(self._exploring):
            rt.invalidate_decision(op, dims, dtype_bytes, backend)
        self._exploring.clear()
        if self._explore_rng.random() >= eps:
            return 0
        served = sorted(k for k in rt.stats.buckets
                        if rt.has(k[1], k[2], k[0])
                        and rt.peek(k[1], k[3], k[2], k[0]) is not None)
        if not served:
            return 0
        key = served[self._explore_rng.randrange(len(served))]
        backend, op, dtype_bytes, dims = key
        space = getattr(rt.subroutine(op, dtype_bytes, backend),
                        "knob_space", None)
        if space is None:
            return 0
        current = rt.peek(op, dims, dtype_bytes, backend)
        cands = [c for c in space.candidates
                 if c != current
                 and not rt.is_quarantined(op, dtype_bytes, backend, c)]
        if not cands:
            return 0
        knob = cands[self._explore_rng.randrange(len(cands))]
        if rt.override_decision(op, dims, dtype_bytes, backend, knob):
            self._exploring[key] = knob
            self.stats.explorations += 1
            return 1
        return 0

    def retune(self, sub_key: tuple) -> "object":
        """Refit one subroutine on the blended install+telemetry dataset and
        hot-swap it into the runtime; returns the new subroutine."""
        backend, op, dtype_bytes = sub_key
        rt = self.runtime
        if self._faults is not None:
            self._faults.fire("retuner_refit", sub_key=sub_key)
        sub = rt.subroutine(op, dtype_bytes, backend)
        with self._lock:
            st = self._state.get(sub_key)
            if st is None or not st.samples:
                raise RuntimeError(f"no telemetry for {sub_key}")
            blended = self._blend(sub, st)
        cfg = self.config
        candidates = cfg.candidates if cfg.candidates is not None \
            else (sub.model_name,)
        new_sub = install_subroutine(
            op, sub.knob_space, lambda dims, knob: 0.0, dataset=blended,
            dtype_bytes=dtype_bytes, candidates=candidates,
            log_target=sub.log_target, use_lof=cfg.use_lof,
            tune_trials=cfg.tune_trials, seed=cfg.seed, keep_dataset=True,
            backend=getattr(sub, "backend", backend))
        if self.registry is not None:
            # stamps the next monotonically increasing artifact_version and
            # persists, so a restarted process loads THIS generation and a
            # pre-swap decision cache is rejected at import
            self.registry.save(new_sub)
        else:
            new_sub.artifact_version = \
                int(getattr(sub, "artifact_version", 0) or 0) + 1
        invalidated = rt.swap(new_sub, backend=backend)
        with self._lock:
            self._state.pop(sub_key, None)   # fresh signal vs the new model
        self.stats.retunes += 1
        self.stats.swap_invalidations += invalidated
        self.events.append({
            "sub_key": sub_key, "model": new_sub.model_name,
            "artifact_version": int(new_sub.artifact_version),
            "invalidated": invalidated,
            "telemetry_rows": len(st.samples)})
        return new_sub

    @staticmethod
    def _equiv_groups(space, dims_arr: np.ndarray) -> list[list[int]]:
        """Feature-equivalence classes of the knob space over ``dims_arr``.

        The Table-III features see a knob only through its parallelism
        measure ``nt`` — two knobs whose nt agrees on every dims row (the
        bk-twins of a GEMM block space, for example) are ONE point in
        feature space.  Supervision must treat them identically: correcting
        or overriding just one of them hands the model contradictory
        targets for the same feature vector, and the uncorrected twin's
        stale cheap time wins the argmin right back."""
        P = np.stack([space.parallelism_vec(tuple(int(v) for v in d))
                      for d in dims_arr])            # (S, K)
        sig: dict[bytes, list[int]] = {}
        for j in range(P.shape[1]):
            sig.setdefault(np.ascontiguousarray(P[:, j]).tobytes(),
                           []).append(j)
        groups = [None] * P.shape[1]
        for members in sig.values():
            for j in members:
                groups[j] = members
        return groups

    def _blend(self, sub, st: _SubState) -> TimingDataset:
        """Install ∪ telemetry dataset (see module docstring, "Blending")."""
        space = sub.knob_space
        K = len(space)
        cp = sub.compiled() if hasattr(sub, "compiled") else None
        samples = [(d, idx, v) for (d, idx), v in st.samples.items()]
        dims_t = np.asarray([d for d, _, _ in samples], dtype=np.int64)
        ds = getattr(sub, "dataset", None)
        have_install = ds is not None and ds.n_samples
        probe_dims = np.concatenate(
            [np.asarray(ds.dims, dtype=np.int64), dims_t]) \
            if have_install else dims_t
        groups = self._equiv_groups(space, probe_dims)
        if cp is not None:
            rows = np.asarray(cp.predict_times_batch(
                [tuple(d) for d, _, _ in samples]), dtype=np.float64)
        else:
            rows = np.stack([np.asarray(sub.predict_times(tuple(d)),
                                        dtype=np.float64)
                             for d, _, _ in samples])
        for r, (_d, idx, measured) in zip(rows, samples):
            r[groups[idx]] = measured   # ground truth beats prediction
        rep = self.config.telemetry_repeat
        dims_t = np.tile(dims_t, (rep, 1))
        rows = np.tile(rows, (rep, 1))
        if have_install:
            inst_times = np.array(ds.times, dtype=np.float64, copy=True)
            if self.config.correct_install:
                # one factor per column; measured twins in one equivalence
                # group share their ratio (geometric mean on collision)
                log_f = np.zeros(K)
                votes = np.zeros(K, dtype=np.int64)
                for idx, ratio in st.knob_ratio.items():
                    for j in groups[idx]:
                        log_f[j] += np.log(ratio)
                        votes[j] += 1
                nz = votes > 0
                inst_times[:, nz] *= np.exp(log_f[nz] / votes[nz])
            dims_all = np.concatenate([np.asarray(ds.dims, dtype=np.int64),
                                       dims_t])
            times_all = np.concatenate([inst_times, rows])
        else:                           # telemetry-only refit
            dims_all, times_all = dims_t, rows
        assert times_all.shape[1] == K
        return TimingDataset(op=sub.op, dims=dims_all, times=times_all,
                             knob_space=space, dtype_bytes=sub.dtype_bytes)

    # -- background thread ----------------------------------------------------
    def start(self) -> None:
        """Run the loop on a daemon thread every ``interval_s``.  Idempotent
        while running."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._halt.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="adsala-retuner", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> bool:
        """Halt the loop; idempotent.  Returns True when the thread fully
        stopped (no swap runs after a True return).  A join that times out
        — the thread is mid-refit and a refit can outlast any reasonable
        close budget — returns False and counts an abandoned stop; the
        thread reference is *kept* (not leaked silently, not nulled while
        alive) so a later stop() can finish the join, and the halted loop
        exits on its own once the in-flight step completes."""
        self._halt.set()
        t = self._thread
        if t is None:
            return True
        t.join(timeout=timeout)
        if t.is_alive():
            self.stats.abandoned_stops += 1
            return False
        self._thread = None
        return True

    def _loop(self) -> None:
        # consecutive failing steps back the poll off exponentially (capped
        # at 8× interval): a persistently crashing refit or observe must
        # neither kill the daemon nor spin it at full rate against the
        # same error
        failures = 0
        while not self._halt.wait(
                self.config.interval_s * min(1 << failures, 8)):
            before = (self.stats.errors + self.stats.observe_failures)
            t0 = time.perf_counter()
            try:
                self.step()
            except Exception as e:      # noqa: BLE001 — never kill serving
                self.stats.errors += 1
                self.stats.last_error = f"{type(e).__name__}: {e}"
            failed = (self.stats.errors
                      + self.stats.observe_failures) > before
            failures = failures + 1 if failed else 0
            # a pathological refit storm must not starve the stop signal
            if time.perf_counter() - t0 > 10 * self.config.interval_s:
                continue
