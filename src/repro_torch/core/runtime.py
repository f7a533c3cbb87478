"""AdsalaRuntime — the runtime library (paper Fig. 1b), backend-keyed.

Loads persisted :class:`TunedSubroutine` artifacts and, per BLAS call,
predicts the runtime of every knob candidate and applies the argmin.  The
paper memoizes the *last* call's dims→decision; we keep that behaviour and
additionally offer a bounded LRU cache (beyond-paper, DESIGN.md §7.2) —
transformer workloads emit a small set of distinct GEMM shapes, so the hit
rate is near 1 after the first step.

Beyond the paper's single-library setting, one runtime instance holds tuned
model sets for several execution backends side by side: the subroutine table
and the decision cache are keyed by ``(backend, op, dtype_bytes)``, and
:class:`RuntimeStats` reports hit-rate per backend.

Hot-path design (this is the most-called code in the serving stack):

* **Cache hits are lock-free.**  The decision cache is a plain dict whose
  reads are GIL-atomic; the authoritative LRU order lives in a mirrored
  ``OrderedDict`` that is only touched under the lock.  A hit records its
  key in a lock-free touch log which is folded into the LRU order on the
  next locked operation (miss, export, import) — "relaxed LRU": recency is
  applied in batches, eviction decisions still honour it.
* **Hit statistics are relaxed striped counters.**  Each thread owns a
  private hit-count dict (no lost updates, no lock, no contention); the
  ``stats`` property aggregates base counters + stripes under the lock.
* **Misses are sharded per ``(backend, op)``.**  Each shard owns a lock, an
  in-flight table, and its eval counters: concurrent misses on *different*
  subroutines never touch the same lock, and concurrent misses on the
  *same* key coalesce — one thread evaluates, the rest wait on the shard's
  in-flight entry and count as hits (the knob they got was served from a
  computation already paid for).  Evaluation itself runs with NO lock held,
  through the :class:`~repro_torch.core.fastpath.CompiledPredictor` built at
  ``register()`` time (falling back to the artifact's reference ``select``
  when compilation isn't possible).  The single remaining global-lock
  section is the LRU store — a dict insert plus occasional eviction; the
  relaxed-LRU touch fold now runs only when an eviction is actually due,
  not on every miss.
* **select_many** batches the misses of several pending decisions sharing a
  subroutine into ONE fused feature-build + model-predict call — the
  serving layer routes bucket flushes through it.
* **Models can be hot-swapped while serving.**  :meth:`AdsalaRuntime.swap`
  replaces a subroutine's model, bumps its swap epoch, and invalidates its
  decision-cache entries in one critical section; miss-path evaluations
  snapshot the epoch and refuse to store a decision computed against a
  superseded model.  In-flight selects finish on the old predictor, every
  select that starts after the swap returns sees the new one.  The online
  retuner (the reference's ``serving/retune.py``) drives this seam.
  Decision-cache exports carry each subroutine's registry-stamped
  ``artifact_version`` so a warm restart rejects entries from a different
  model generation.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

from .fastpath import compile_predictor
from .knobs import Knob
from .tuner import TunedSubroutine

__all__ = ["AdsalaRuntime", "BackendStats", "BucketStats", "RuntimeStats",
           "global_runtime", "DEFAULT_BACKEND"]

#: backend assumed when a caller or a legacy (v1) artifact names none
DEFAULT_BACKEND = "hopper"

#: fold the lock-free touch log into the LRU order at this size even if no
#: miss comes along (bounds memory on hit-only workloads)
_TOUCH_FOLD_LIMIT = 1024


class _Inflight:
    """One in-progress model evaluation: followers wait on ``event`` and
    read ``knob`` (None means the leader failed — fall back to a local
    evaluation).  ``event`` may be shared: ``select_many`` backs all the
    keys of one fused evaluation with a single Event (they resolve
    together, and per-key Event allocation is measurable on the batched
    path).  ``epoch`` is the subroutine's swap epoch at the leader's
    snapshot: a follower whose own snapshot is newer must NOT ride this
    evaluation — the leader is computing against a predecessor model."""
    __slots__ = ("event", "knob", "epoch")

    def __init__(self, event: threading.Event | None = None,
                 epoch: int = 0) -> None:
        self.event = event if event is not None else threading.Event()
        self.knob: Knob | None = None
        self.epoch = epoch


class _Shard:
    """Per-``(backend, op)`` miss-path state: its own lock, the in-flight
    evaluation table (duplicate-key coalescing), and relaxed eval counters
    (folded into :class:`RuntimeStats` by the ``stats`` aggregator)."""
    __slots__ = ("lock", "inflight", "model_evals", "eval_seconds")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.inflight: dict[tuple, _Inflight] = {}
        self.model_evals = 0
        self.eval_seconds = 0.0

    def count_eval(self, dt: float, n: int = 1) -> None:
        with self.lock:
            self.model_evals += n
            self.eval_seconds += dt

    def snapshot(self) -> tuple[int, float]:
        """(model_evals, eval_seconds) read together under the shard lock.
        A lock-free reader racing ``count_eval`` could observe the
        incremented count without the added seconds — the pair must be
        taken in one critical section to stay mutually consistent."""
        with self.lock:
            return self.model_evals, self.eval_seconds


class _HitStripe:
    """Per-thread relaxed hit counter: a run-length count for the backend
    currently being hit (the overwhelmingly common case is a long run of one
    backend) plus a dict of folded totals.  Only the owning thread writes;
    the stats aggregator reads both parts under the runtime lock, and folds
    the stripe away once its owner thread has exited."""
    __slots__ = ("owner", "backend", "n", "counts")

    def __init__(self) -> None:
        self.owner = threading.current_thread()
        self.backend: str | None = None
        self.n = 0
        self.counts: dict[str, int] = {}

    def switch(self, backend: str) -> None:
        # zero the run BEFORE folding it: a stats read racing this switch
        # then transiently undercounts the run instead of double-counting it
        prev = self.backend
        n = self.n
        self.n = 0
        if prev is not None and n:
            self.counts[prev] = self.counts.get(prev, 0) + n
        self.backend = backend

    def pairs(self) -> list[tuple[str, int]]:
        out = list(self.counts.items())
        run_backend, run_n = self.backend, self.n
        if run_backend is not None and run_n:
            out.append((run_backend, run_n))
        return out


@dataclasses.dataclass
class BackendStats:
    calls: int = 0
    cache_hits: int = 0
    default_calls: int = 0      # select_or_default served the fallback knob
    model_evals: int = 0        # knob decisions that ran the ML model
    eval_seconds: float = 0.0

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / self.calls if self.calls else 0.0


@dataclasses.dataclass
class BucketStats:
    """Serving-layer accounting for one shape bucket (= one decision-cache
    key): how many stacked executions it saw, how well they amortised, and
    where its requests' time went.  ``exec_seconds`` covers ONLY the
    stacked ``run_op`` span; scheduler-side queue/linger wait is accounted
    separately in ``queue_seconds`` — mixing the two would poison the
    online retrainer's telemetry with batching-policy artifacts."""
    batches: int = 0
    requests: int = 0
    max_batch: int = 0
    exec_seconds: float = 0.0     # sum of stacked-execution spans
    exec_items: int = 0           # stacked rows executed (incl. pad filler)
    queue_seconds: float = 0.0    # sum over requests of submit→exec-start

    @property
    def mean_batch(self) -> float:
        return self.requests / self.batches if self.batches else 0.0

    @property
    def mean_exec_per_item(self) -> float:
        """Mean measured execution seconds per stacked row — the telemetry
        signal the drift detector compares against the install-time
        predictor's per-call prediction."""
        return self.exec_seconds / self.exec_items if self.exec_items else 0.0

    @property
    def mean_queue(self) -> float:
        return self.queue_seconds / self.requests if self.requests else 0.0


@dataclasses.dataclass
class RuntimeStats:
    calls: int = 0
    cache_hits: int = 0
    default_calls: int = 0
    model_evals: int = 0
    eval_seconds: float = 0.0
    #: import_cache entries rejected because they were decided by a
    #: different artifact generation (stale persisted cache)
    import_drops_version: int = 0
    #: import_cache entries rejected because their knob left the registered
    #: candidate space (recalibration changed the space)
    import_drops_knob: int = 0
    #: hot swaps applied (online retune / reinstall) and the decision-cache
    #: entries they invalidated
    swaps: int = 0
    swap_invalidations: int = 0
    #: knob quarantines opened (TTL'd circuit breakers on crashing knobs)
    quarantines: int = 0
    #: selections that re-chose a quarantined knob and were forced onto the
    #: quarantine's fallback config instead
    quarantine_forced: int = 0
    #: import_cache entries rejected because their knob is under an active
    #: quarantine (a crashing selection must not be resurrected by warm start)
    import_drops_quarantine: int = 0
    #: miss-path model evaluations that raised; select_or_default served the
    #: caller's default config instead of failing the BLAS call
    eval_failures: int = 0
    #: import_cache entries dropped as structurally malformed (missing
    #: fields, wrong types — a payload that passed the durable checksums or
    #: came from a legacy file but does not parse as a record)
    import_drops_corrupt: int = 0
    #: decision-journal appends that raised (persistence is best-effort on
    #: the hot path — a full disk must cost durability, not availability)
    journal_failures: int = 0
    #: decisions/quarantines absorbed from a shared fleet journal (peer
    #: processes' entries imported via :meth:`AdsalaRuntime.absorb_journal`)
    journal_absorbed: int = 0
    backends: dict[str, BackendStats] = dataclasses.field(
        default_factory=dict)
    #: per shape-bucket serving stats, keyed (backend, op, dtype_bytes, dims)
    buckets: dict[tuple, BucketStats] = dataclasses.field(
        default_factory=dict)

    def for_backend(self, name: str) -> BackendStats:
        return self.backends.setdefault(name, BackendStats())

    def for_bucket(self, key: tuple) -> BucketStats:
        return self.buckets.setdefault(key, BucketStats())

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / self.calls if self.calls else 0.0

    @property
    def backend_hit_rates(self) -> dict[str, float]:
        return {name: b.hit_rate for name, b in sorted(self.backends.items())}


class AdsalaRuntime:
    """Per-process decision engine for all tuned (backend, subroutine) pairs.

    ``fast_prune=True`` opts registered artifacts into dominated-candidate
    pruning (see :mod:`~repro_torch.core.fastpath`): the compiled fast path then
    evaluates only the knobs the install-time dataset ever argmin-selected,
    falling back to the full candidate set outside the dataset's dims
    range.  ``fast_prune="band"`` uses the confidence-band live set instead
    (every knob whose prediction ever came within the persisted band of the
    winner — a robust superset).  ``fast_knn_coreset=True`` opts KNN
    artifacts into their persisted inexact subsample.
    """

    def __init__(self, *, cache_size: int = 256, fast_prune=False,
                 touch_sample: int = 16,
                 fast_knn_coreset: bool = False, faults=None) -> None:
        # paper's behaviour = cache_size 1 (last call only)
        #: optional fault plan (the reference's serving/faults.py); every
        #: site is guarded by an `is not None` check so the disabled
        #: (default) path is free
        self._faults = faults
        self._subs: dict[tuple[str, str, int], TunedSubroutine] = {}
        self._fast: dict[tuple[str, str, int], object] = {}
        self._shards: dict[tuple[str, str], _Shard] = {}
        # per-subroutine swap epoch: bumped (under the lock) whenever the
        # registered model for a key is replaced.  Miss-path evaluations
        # snapshot it before reading the model and refuse to STORE a knob
        # computed against a superseded epoch — an in-flight select may
        # still RETURN the old decision (it was in flight when the swap
        # landed), but it can never repollute the invalidated cache
        self._swap_epochs: dict[tuple[str, str, int], int] = {}
        # TTL'd knob circuit breakers: (backend, op, dtype_bytes, knob) ->
        # (monotonic expiry deadline, forced fallback knob).  The cache
        # never holds a quarantined knob (quarantine_knob invalidates, the
        # miss path refuses to store one), so the lock-free HIT path needs
        # no quarantine check at all — only miss-path evaluations consult
        # this dict, and only when it is non-empty.
        self._quarantined: dict[tuple, tuple[float, Knob]] = {}
        self._cache: collections.OrderedDict[tuple, Knob] = \
            collections.OrderedDict()      # authoritative LRU, lock-guarded
        self._cache_mirror: dict[tuple, Knob] = {}   # lock-free read mirror
        self._cache_size = max(1, cache_size)
        self._fast_prune = fast_prune
        self._fast_knn_coreset = bool(fast_knn_coreset)
        self._lock = threading.RLock()
        self._touches: list[tuple] = []    # lock-free hit log (relaxed LRU)
        # hits log a recency touch every `touch_sample`-th hit of a thread's
        # run (power of two; 1 = every hit, for deterministic LRU tests)
        if touch_sample < 1 or touch_sample & (touch_sample - 1):
            raise ValueError("touch_sample must be a power of two")
        self._touch_mask = touch_sample - 1
        self._hits_local = threading.local()
        self._hit_stripes: list[_HitStripe] = []
        self._base = RuntimeStats()        # mutated only under the lock
        #: optional incremental persistence hook (e.g. bound to
        #: ``ModelRegistry.journal_decision``): called best-effort, outside
        #: the lock, with one export_cache-shaped record per NEW cached
        #: decision and per quarantine opened.  Failures are counted
        #: (``stats.journal_failures``), never raised.
        self.decision_journal = None
        # error-budget ledger riding export/import (attach_budgets); budget
        # records imported before a ledger is attached are parked here
        self._budgets = None
        self._pending_budget_records: list[dict] = []
        # prebound lock-free readers (the dicts/lists are mutated in place,
        # never replaced, so these stay valid for the runtime's life)
        self._cache_get = self._cache_mirror.get
        self._subs_get = self._subs.get
        self._fast_get = self._fast.get
        self._shards_get = self._shards.get
        self._epoch_get = self._swap_epochs.get

    # -- statistics -----------------------------------------------------------
    @staticmethod
    def _add_hits(stats: RuntimeStats, name: str, hits: int) -> None:
        stats.calls += hits
        stats.cache_hits += hits
        b = stats.for_backend(name)
        b.calls += hits
        b.cache_hits += hits

    @property
    def stats(self) -> RuntimeStats:
        """Aggregate snapshot: locked base counters plus the per-thread
        relaxed hit stripes.  Exact whenever the hitting threads are
        quiescent (e.g. after join); a read racing a live hit may lag it by
        a moment.  Stripes of exited threads are folded into the base here,
        so thread churn cannot grow the stripe list unboundedly."""
        with self._lock:
            base = self._base
            self._prune_stripes_locked()
            merged = RuntimeStats(
                calls=base.calls, cache_hits=base.cache_hits,
                default_calls=base.default_calls,
                model_evals=base.model_evals,
                eval_seconds=base.eval_seconds,
                import_drops_version=base.import_drops_version,
                import_drops_knob=base.import_drops_knob,
                swaps=base.swaps,
                swap_invalidations=base.swap_invalidations,
                quarantines=base.quarantines,
                quarantine_forced=base.quarantine_forced,
                import_drops_quarantine=base.import_drops_quarantine,
                eval_failures=base.eval_failures,
                import_drops_corrupt=base.import_drops_corrupt,
                journal_failures=base.journal_failures,
                journal_absorbed=base.journal_absorbed,
                backends={n: dataclasses.replace(b)
                          for n, b in base.backends.items()},
                buckets={k: dataclasses.replace(b)
                         for k, b in base.buckets.items()})
            for stripe in self._hit_stripes:
                for name, hits in stripe.pairs():
                    self._add_hits(merged, name, hits)
            for (backend, _op), shard in self._shards.items():
                # snapshot BOTH counters under the shard lock: an unlocked
                # pair of reads racing count_eval on another thread could
                # see the incremented count without the added seconds
                evals, secs = shard.snapshot()
                if evals or secs:
                    merged.calls += evals
                    merged.model_evals += evals
                    merged.eval_seconds += secs
                    b = merged.for_backend(backend)
                    b.calls += evals
                    b.model_evals += evals
                    b.eval_seconds += secs
        return merged

    def _stripe(self) -> _HitStripe:
        """This thread's hit stripe (registered for aggregation on first
        use).  Registration also folds away stripes of exited threads, so
        thread churn can't leak stripes even if nobody ever reads stats."""
        stripe = _HitStripe()
        self._hits_local.stripe = stripe
        with self._lock:
            self._prune_stripes_locked()
            self._hit_stripes.append(stripe)
        return stripe

    def _prune_stripes_locked(self) -> None:
        """Fold exited threads' (final, immutable) counters into the base."""
        live: list[_HitStripe] = []
        for stripe in self._hit_stripes:
            if stripe.owner.is_alive():
                live.append(stripe)
            else:
                for name, hits in stripe.pairs():
                    self._add_hits(self._base, name, hits)
        self._hit_stripes[:] = live

    def _record_hit(self, backend: str, key: tuple, n: int = 1) -> None:
        """Lock-free hit accounting: thread-owned stripe + sampled touch
        log.  select() inlines an n=1 copy of this logic on its hot path —
        keep the two in step."""
        try:
            s = self._hits_local.stripe
        except AttributeError:
            s = self._stripe()
        if backend is not s.backend and backend != s.backend:
            s.switch(backend)
        s.n += n
        if not (s.n & self._touch_mask):
            touches = self._touches
            touches.append(key)
            if len(touches) >= _TOUCH_FOLD_LIMIT:
                with self._lock:
                    self._fold_touches_locked()

    def _fold_touches_locked(self) -> None:
        """Apply the pending lock-free hit log to the LRU order.  Drains the
        touch list in place (the list object is never replaced): appends
        racing the drain land at the tail and survive for the next fold."""
        touches = self._touches
        if not touches:
            return
        pending = touches[:]
        del touches[:len(pending)]
        cache = self._cache
        for key in pending:
            if key in cache:
                cache.move_to_end(key)

    # -- registration --------------------------------------------------------
    def register(self, sub: TunedSubroutine, *,
                 backend: str | None = None) -> None:
        name = backend or getattr(sub, "backend", None) or DEFAULT_BACKEND
        # compile the fast path up front (None for stubs/uncompilable subs:
        # select() then falls back to the artifact's reference path)
        compiled = compile_predictor(sub, prune=self._fast_prune,
                                     coreset=self._fast_knn_coreset)
        sub_key = (name, sub.op, sub.dtype_bytes)
        with self._lock:
            if sub_key in self._subs:
                # replacing a live model: in-flight evaluations against the
                # old one must not store their (stale) decisions
                self._swap_epochs[sub_key] = \
                    self._swap_epochs.get(sub_key, 0) + 1
            self._subs[sub_key] = sub
            self._fast[sub_key] = compiled

    def swap(self, sub: TunedSubroutine, *,
             backend: str | None = None) -> int:
        """Atomically hot-swap the registered model for ``sub``'s key and
        invalidate its decision-cache entries; returns how many cached
        decisions were invalidated.

        The replacement, the epoch bump, and the cache invalidation happen
        in ONE critical section: a ``select`` that starts after ``swap``
        returns can neither hit a cached decision of the old model nor ride
        an in-flight evaluation the old model is still computing (the
        epoch stamp on the in-flight entry no longer matches).  Calls
        already past the cache probe finish on the old predictor — they
        were in flight when the swap landed — but their results are never
        stored.  This is the online-retune seam: the fast-path predictor is
        compiled *before* the lock is taken, so the critical section is a
        few dict operations regardless of model family."""
        name = backend or getattr(sub, "backend", None) or DEFAULT_BACKEND
        compiled = compile_predictor(sub, prune=self._fast_prune,
                                     coreset=self._fast_knn_coreset)
        sub_key = (name, sub.op, sub.dtype_bytes)
        with self._lock:
            self._swap_epochs[sub_key] = self._swap_epochs.get(sub_key, 0) + 1
            self._subs[sub_key] = sub
            self._fast[sub_key] = compiled
            self._fold_touches_locked()
            stale = [k for k in self._cache if k[:3] == sub_key]
            for k in stale:
                del self._cache[k]
                self._cache_mirror.pop(k, None)
            self._base.swaps += 1
            self._base.swap_invalidations += len(stale)
        return len(stale)

    # -- error budgets / incremental persistence seams ------------------------
    def attach_budgets(self, ledger) -> None:
        """Hook an error-budget ledger (the reference's serving/budget.py)
        into warm-state persistence: its records ride :meth:`export_cache`, and
        ``{"budget": 1}`` records seen by :meth:`import_cache` (including
        any imported *before* this attach) are restored into it."""
        with self._lock:
            self._budgets = ledger
            pending = self._pending_budget_records
            self._pending_budget_records = []
        if pending:
            ledger.import_records(pending)

    def attached_budgets(self):
        """The attached error-budget ledger, or None."""
        return self._budgets

    def _decision_record(self, key: tuple, knob: Knob) -> dict:
        return {"backend": key[0], "op": key[1], "dtype_bytes": int(key[2]),
                "dims": [int(d) for d in key[3]], "knob": knob.dict,
                "artifact_version": self._version_of(key[:3])}

    def _notify_journal(self, record: dict) -> None:
        """Best-effort incremental persistence: runs OUTSIDE the runtime
        lock (it does file I/O), never raises into the decision path."""
        fn = self.decision_journal
        if fn is None:
            return
        try:
            fn(record)
        except Exception:        # noqa: BLE001 — durability, not availability
            with self._lock:
                self._base.journal_failures += 1

    # -- knob quarantine (TTL'd circuit breakers) -----------------------------
    def quarantine_knob(self, op: str, dtype_bytes: int, backend: str,
                        knob: Knob, *, fallback: Knob,
                        ttl_s: float = 30.0) -> int:
        """Open a TTL'd circuit breaker on one ``(backend, op, dtype, knob)``:
        until the breaker half-opens (``ttl_s`` seconds of monotonic time),
        every miss-path selection that re-chooses ``knob`` is forced onto
        ``fallback`` instead, and the forced decision is never cached.  The
        serving layer opens breakers on knob-specific kernel crashes — a
        selection that takes the kernel down must not be served again the
        moment the request is retried.

        Cached decisions equal to ``knob`` are invalidated in the same
        critical section that opens the breaker (returns how many), which is
        what keeps the lock-free hit path free of quarantine checks: the
        cache simply never contains a quarantined knob."""
        fallback_knob = fallback
        if fallback_knob == knob:
            raise ValueError("quarantine fallback must differ from the "
                             "quarantined knob")
        sub_key = (backend, op, int(dtype_bytes))
        with self._lock:
            self._fold_touches_locked()
            self._quarantined[sub_key + (knob,)] = \
                (time.monotonic() + float(ttl_s), fallback_knob)
            self._base.quarantines += 1
            stale = [k for k, v in self._cache.items()
                     if k[:3] == sub_key and v == knob]
            for k in stale:
                del self._cache[k]
                self._cache_mirror.pop(k, None)
        if self.decision_journal is not None:
            # an opened breaker must survive a crash before the next full
            # snapshot — a crashing knob coming back on restart is exactly
            # the failure mode quarantines exist to prevent
            self._notify_journal(
                {"quarantine": 1, "backend": backend, "op": op,
                 "dtype_bytes": int(dtype_bytes), "knob": knob.dict,
                 "fallback_knob": fallback_knob.dict, "ttl_s": float(ttl_s)})
        return len(stale)

    def unquarantine(self, op: str, dtype_bytes: int, backend: str,
                     knob: Knob) -> bool:
        with self._lock:
            return self._quarantined.pop(
                (backend, op, int(dtype_bytes), knob), None) is not None

    def is_quarantined(self, op: str, dtype_bytes: int, backend: str,
                       knob: Knob) -> bool:
        """True while the breaker is open; an elapsed TTL expires lazily
        here (the probe itself half-opens the breaker)."""
        qkey = (backend, op, int(dtype_bytes), knob)
        with self._lock:
            ent = self._quarantined.get(qkey)
            if ent is None:
                return False
            if time.monotonic() >= ent[0]:
                del self._quarantined[qkey]
                return False
            return True

    def quarantined_knobs(self) -> dict[tuple, float]:
        """Active breakers: (backend, op, dtype_bytes, knob) → remaining TTL
        seconds.  Expired entries are reaped as a side effect."""
        now = time.monotonic()
        with self._lock:
            for k in [k for k, (dl, _) in self._quarantined.items()
                      if now >= dl]:
                del self._quarantined[k]
            return {k: dl - now for k, (dl, _) in self._quarantined.items()}

    def _apply_quarantine(self, sub_key: tuple,
                          knob: Knob) -> tuple[Knob, bool]:
        """Miss-path filter: map a freshly evaluated knob through any active
        breaker → ``(knob_to_serve, ok_to_store)``.  The no-breakers case
        (always, in a healthy process) is one GIL-atomic emptiness check."""
        if not self._quarantined:
            return knob, True
        qkey = sub_key + (knob,)
        with self._lock:
            ent = self._quarantined.get(qkey)
            if ent is None:
                return knob, True
            if time.monotonic() >= ent[0]:
                # TTL elapsed: half-open — serve the model's choice again
                # (and cache it; a recurrence re-opens the breaker)
                del self._quarantined[qkey]
                return knob, True
            self._base.quarantine_forced += 1
            # the forced fallback is NOT stored: the cache must keep tempting
            # the miss path to re-ask the model, so expiry is actually seen
            return ent[1], False

    # -- retuner exploration seam ---------------------------------------------
    def override_decision(self, op: str, dims: tuple[int, ...],
                          dtype_bytes: int, backend: str,
                          knob: Knob) -> bool:
        """Force the decision cache to serve ``knob`` for one shape key (the
        retuner's bounded-epsilon exploration).  Refuses actively
        quarantined knobs — exploration must never re-serve a crashing
        config; returns False when refused."""
        if type(dims) is not tuple:
            dims = tuple(dims)
        sub_key = (backend, op, int(dtype_bytes))
        with self._lock:
            ent = self._quarantined.get(sub_key + (knob,))
            if ent is not None:
                if time.monotonic() < ent[0]:
                    return False
                del self._quarantined[sub_key + (knob,)]
            self._store_locked(sub_key + (dims,), knob)
        return True

    def invalidate_decision(self, op: str, dims: tuple[int, ...],
                            dtype_bytes: int, backend: str) -> bool:
        """Drop one cached decision so the next selection re-runs the model
        (exploration restore / targeted invalidation).  Returns whether an
        entry existed."""
        if type(dims) is not tuple:
            dims = tuple(dims)
        key = (backend, op, int(dtype_bytes), dims)
        with self._lock:
            self._fold_touches_locked()
            if key not in self._cache:
                return False
            del self._cache[key]
            self._cache_mirror.pop(key, None)
        return True

    def _version_of(self, sub_key: tuple) -> int:
        """Artifact generation of the registered subroutine (0 when the
        subroutine is unregistered or was never registry-stamped)."""
        sub = self._subs_get(sub_key)
        return int(getattr(sub, "artifact_version", 0) or 0)

    def has(self, op: str, dtype_bytes: int,
            backend: str = DEFAULT_BACKEND) -> bool:
        return self._subs_get((backend, op, dtype_bytes)) is not None

    def subroutine(self, op: str, dtype_bytes: int,
                   backend: str = DEFAULT_BACKEND) -> TunedSubroutine:
        return self._subs[(backend, op, dtype_bytes)]

    def predictor(self, op: str, dtype_bytes: int,
                  backend: str = DEFAULT_BACKEND):
        """The compiled fast-path predictor, or None if uncompilable."""
        return self._fast_get((backend, op, dtype_bytes))

    def peek(self, op: str, dims: tuple[int, ...], dtype_bytes: int = 4,
             backend: str = DEFAULT_BACKEND) -> Knob | None:
        """Lock-free cache probe: the cached knob, or None on a miss.
        Records no statistics and no LRU recency — callers that act on the
        result should go through :meth:`select` (the trace-time batcher
        uses this to route only true misses into a combining window)."""
        if type(dims) is not tuple:
            dims = tuple(dims)
        return self._cache_get((backend, op, dtype_bytes, dims))

    def bucket_stats_peek(self, key: tuple) -> BucketStats | None:
        """Lock-free probe of one shape bucket's LIVE stats object, keyed
        ``(backend, op, dtype_bytes, dims)`` — or None before its first
        recorded batch.  Relaxed by design (a racing ``record_batch`` may
        be mid-update): the serving admission controller reads
        ``mean_queue`` from it as an *estimate* on every submit, which must
        not take the runtime lock."""
        return self._base.buckets.get(key)

    def backends(self) -> tuple[str, ...]:
        """Backend names with at least one registered subroutine."""
        with self._lock:
            return tuple(sorted({k[0] for k in self._subs}))

    # -- the runtime decision -------------------------------------------------
    def select(self, op: str, dims: tuple[int, ...], dtype_bytes: int = 4,
               backend: str = DEFAULT_BACKEND) -> Knob:
        if type(dims) is not tuple:
            dims = tuple(dims)
        key = (backend, op, dtype_bytes, dims)
        knob = self._cache_get(key)          # lock-free GIL-atomic read
        if knob is not None:
            # hot hit path, accounting inlined and lock-free: run-length
            # stripe increment + sampled LRU touch (folded on the next miss)
            try:
                s = self._hits_local.stripe
            except AttributeError:
                s = self._stripe()
            if backend is not s.backend and backend != s.backend:
                s.switch(backend)
            s.n += 1
            if not (s.n & self._touch_mask):
                touches = self._touches
                touches.append(key)
                if len(touches) >= _TOUCH_FOLD_LIMIT:
                    with self._lock:
                        self._fold_touches_locked()
            return knob
        return self._select_miss(key)

    def _shard(self, bk_op: tuple[str, str]) -> _Shard:
        shard = self._shards_get(bk_op)
        if shard is None:
            with self._lock:
                shard = self._shards.setdefault(bk_op, _Shard())
        return shard

    def _select_miss(self, key: tuple) -> Knob:
        backend, op, dtype_bytes, dims = key
        sub_key = (backend, op, dtype_bytes)
        if self._subs_get(sub_key) is None:
            raise KeyError(sub_key)
        epoch = self._epoch_get(sub_key, 0)   # before joining the in-flight
        shard = self._shard((backend, op))
        with shard.lock:
            ent = shard.inflight.get(key)
            leader = ent is None
            if leader:
                ent = shard.inflight[key] = _Inflight(epoch=epoch)
        if not leader:
            # same-key coalescing: ride the evaluation already in flight
            # (a knob served from someone else's paid-for computation is a
            # hit for accounting purposes) — unless that evaluation began
            # before a hot swap we have already observed: its result is the
            # superseded model's decision and must not be served to a call
            # that started after the swap completed
            if ent.epoch == epoch and ent.event.wait(timeout=60.0) \
                    and ent.knob is not None:
                self._record_hit(backend, key)
                return ent.knob
            return self._evaluate_and_store(key, sub_key, shard, epoch)
        try:
            # re-probe after winning leadership: a thread descheduled
            # between the lock-free cache check and here may find the key
            # already stored by a previous leader — serving the cached
            # knob keeps "one eval per key" exact instead of best-effort
            knob = self._cache_get(key)
            if knob is not None:
                ent.knob = knob
                self._record_hit(backend, key)
                return knob
            knob = ent.knob = self._evaluate_and_store(key, sub_key, shard,
                                                       epoch)
            return knob
        finally:
            ent.event.set()
            with shard.lock:
                shard.inflight.pop(key, None)

    def _evaluate_and_store(self, key: tuple, sub_key: tuple,
                            shard: _Shard, epoch: int) -> Knob:
        # model evaluation runs with NO lock held (pure numpy,
        # deterministic) so concurrent distinct-shape selections never
        # serialise; eval statistics live on the (backend, op) shard
        sub = self._subs_get(sub_key)
        fast = self._fast_get(sub_key)
        if self._faults is not None:
            self._faults.fire("predictor_eval", backend=key[0], op=key[1],
                              dtype_bytes=key[2], dims=key[3])
        t0 = time.perf_counter()
        knob = fast.select(key[3]) if fast is not None else sub.select(key[3])
        shard.count_eval(time.perf_counter() - t0)
        knob, store_ok = self._apply_quarantine(sub_key, knob)
        stored = False
        with self._lock:
            # a hot swap invalidated this subroutine's cache entries while
            # we were evaluating: our knob may be the OLD model's decision —
            # return it (this call was in flight) but never store it
            if store_ok and self._swap_epochs.get(sub_key, 0) == epoch:
                self._store_locked(key, knob)
                stored = True
        if stored and self.decision_journal is not None:
            self._notify_journal(self._decision_record(key, knob))
        return knob

    def _store_locked(self, key: tuple, knob: Knob) -> None:
        cache = self._cache
        if len(cache) >= self._cache_size and key not in cache:
            # an eviction is due: honour pending hit recency first.  (The
            # fold used to run on every miss; eviction time is the only
            # point the relaxed LRU order is actually consulted.)
            self._fold_touches_locked()
        cache[key] = knob
        cache.move_to_end(key)
        self._cache_mirror[key] = knob
        while len(cache) > self._cache_size:
            old, _ = cache.popitem(last=False)
            self._cache_mirror.pop(old, None)

    def select_or_default(self, op: str, dims: tuple[int, ...],
                          dtype_bytes: int, default: Knob, *,
                          backend: str = DEFAULT_BACKEND) -> Knob:
        """Graceful degradation: untuned subroutines run the default config
        (a node that lost its model files keeps serving — fault tolerance).
        Default-path calls are recorded so `RuntimeStats` sees all traffic.

        A miss-path model evaluation that *raises* degrades the same way —
        the caller gets the default config instead of a failed BLAS call,
        and the failure is counted in ``stats.eval_failures`` (a broken
        predictor must cost performance, never availability).

        The registered-subroutine check is a lock-free read, so the common
        cases cost one lock acquisition (default, miss) or zero (hit)
        instead of the old check-release-reacquire round trip."""
        if self._subs_get((backend, op, dtype_bytes)) is None:
            with self._lock:
                base = self._base
                base.calls += 1
                base.default_calls += 1
                b = base.for_backend(backend)
                b.calls += 1
                b.default_calls += 1
            return default
        try:
            return self.select(op, dims, dtype_bytes, backend=backend)
        except Exception:
            with self._lock:
                base = self._base
                base.calls += 1
                base.default_calls += 1
                base.eval_failures += 1
                b = base.for_backend(backend)
                b.calls += 1
                b.default_calls += 1
            return default

    # -- batched decisions ----------------------------------------------------
    def select_many(self, requests, *,
                    record_hits: bool = True) -> list[Knob | None]:
        """Batched knob selection.

        ``requests`` is a sequence of ``(op, dims, dtype_bytes, backend)``
        tuples; returns one Knob per request (``None`` where no subroutine
        is registered — callers treat those like the select_or_default
        fallback).  Hits resolve lock-free exactly like :meth:`select`.
        All missing keys that share one subroutine are evaluated in a
        single fused feature-build + model-predict call, then stored under
        one lock acquisition.  Decisions and statistics match N individual
        ``select`` calls (duplicate keys beyond the first count as hits).

        ``record_hits=False`` keeps cache hits out of the statistics (model
        evaluations are always recorded — they really ran).  The serving
        prewarm uses this so speculative decision lookups don't inflate the
        hit rate the executors' own selections report.
        """
        out: list[Knob | None] = [None] * len(requests)
        misses: dict[tuple, list[int]] = {}
        for i, (op, dims, dtype_bytes, backend) in enumerate(requests):
            if type(dims) is not tuple:
                dims = tuple(dims)
            key = (backend, op, dtype_bytes, dims)
            knob = self._cache_get(key)
            if knob is not None:
                if record_hits:
                    self._record_hit(backend, key)
                out[i] = knob
            else:
                misses.setdefault(key, []).append(i)
        if not misses:
            return out

        # missing keys join the same per-shard in-flight protocol as the
        # one-at-a-time miss path, so a select_many racing a concurrent
        # select (or another select_many) on the same key still costs ONE
        # model evaluation total — the serving prewarm races the workers'
        # own selections by design, and without this the loser of the race
        # double-counted (and double-paid) the evaluation
        shard_groups: dict = {}               # shard -> [keys]
        epochs: dict[tuple, int] = {}         # sub_key -> swap epoch snapshot
        for key in misses:
            if self._subs_get(key[:3]) is None:
                continue                      # unregistered: stays None
            if key[:3] not in epochs:         # before joining the in-flight
                epochs[key[:3]] = self._epoch_get(key[:3], 0)
            shard_groups.setdefault(self._shard(key[:2]), []).append(key)
        by_sub: dict[tuple, list[tuple]] = {}
        owned: dict[tuple, tuple] = {}        # key -> (_Inflight, shard)
        followers: dict[tuple, object] = {}   # key -> someone else's entry
        resolved: dict[tuple, Knob] = {}
        # one shared Event backs every key this call leads (they resolve
        # together in the fused evaluation), and registration takes each
        # shard's lock once for its whole key group — per-key locking and
        # Event allocation were measurable on the 64-key batched path
        batch_event = threading.Event()
        for shard, keys in shard_groups.items():
            with shard.lock:
                for key in keys:
                    ent = shard.inflight.get(key)
                    if ent is None:
                        ent = shard.inflight[key] = _Inflight(
                            batch_event, epoch=epochs[key[:3]])
                        owned[key] = (ent, shard)
                    else:
                        followers[key] = ent
        for key in list(owned):
            # we lead these keys — re-probe after winning leadership (a
            # previous leader may have stored one between our lock-free
            # miss and here), keeping "one eval per key" exact; the entry
            # stays registered until the shared release below
            knob = self._cache_get(key)
            if knob is not None:
                resolved[key] = knob
                if record_hits:
                    self._record_hit(key[0], key)
                continue
            by_sub.setdefault(key[:3], []).append(key)
        no_store: set[tuple] = set()          # quarantine-forced decisions
        stored_keys: list[tuple] = []         # journaled after the release
        try:
            for sub_key, keys in by_sub.items():
                sub = self._subs_get(sub_key)
                fast = self._fast_get(sub_key)
                try:
                    if self._faults is not None:
                        self._faults.fire(
                            "predictor_eval", backend=sub_key[0],
                            op=sub_key[1], dtype_bytes=sub_key[2],
                            n=len(keys))
                    t0 = time.perf_counter()
                    if fast is not None:
                        knobs = fast.select_many([k[3] for k in keys])
                    else:
                        knobs = [sub.select(k[3]) for k in keys]
                except Exception:
                    # a failed fused evaluation degrades only its own group:
                    # the keys stay unresolved (callers treat None like the
                    # untuned default) instead of poisoning the whole batch
                    with self._lock:
                        self._base.eval_failures += len(keys)
                    continue
                # eval statistics live on the (backend, op) shard, like
                # the one-at-a-time miss path
                self._shard(sub_key[:2]).count_eval(
                    time.perf_counter() - t0, n=len(keys))
                for key, knob in zip(keys, knobs):
                    knob, store_ok = self._apply_quarantine(sub_key, knob)
                    resolved[key] = knob
                    if not store_ok:
                        no_store.add(key)
            if owned:
                with self._lock:
                    for key in owned:
                        knob = resolved.get(key)
                        # skip keys whose subroutine was hot-swapped while
                        # we evaluated: the knob is the old model's decision
                        # (returned to this in-flight caller, never stored) —
                        # and quarantine-forced fallbacks, which must never
                        # shadow the model's real choice in the cache
                        if knob is not None and key not in no_store \
                                and self._swap_epochs.get(
                                    key[:3], 0) == epochs[key[:3]]:
                            self._store_locked(key, knob)
                            stored_keys.append(key)
        finally:
            # release owned entries BEFORE waiting on anyone else's (no
            # wait cycles possible); a failed evaluation releases with
            # knob=None so racers fall back to their own eval.  Knobs are
            # published before the single shared-event set, and the
            # removals take each shard's lock once.
            for key, (ent, _shard) in owned.items():
                ent.knob = resolved.get(key)
            batch_event.set()
            for shard, keys in shard_groups.items():
                with shard.lock:
                    for key in keys:
                        if key in owned:
                            shard.inflight.pop(key, None)
        # incremental persistence AFTER the in-flight release: journal file
        # I/O must never hold followers on the shared event
        if stored_keys and self.decision_journal is not None:
            for key in stored_keys:
                self._notify_journal(self._decision_record(key,
                                                           resolved[key]))
        # absorb keys someone else was already evaluating — their eval,
        # their eval-count; recorded as a hit only when hits are recorded.
        # An entry whose epoch predates our snapshot is a pre-swap leader
        # still computing on the superseded model: evaluate fresh instead.
        for key, ent in followers.items():
            if ent.epoch == epochs[key[:3]] and ent.event.wait(timeout=60.0) \
                    and ent.knob is not None:
                resolved[key] = ent.knob
                if record_hits:
                    self._record_hit(key[0], key)
            else:                 # timed out / leader failed / stale epoch
                try:
                    resolved[key] = self.select(key[1], key[3], key[2],
                                                backend=key[0])
                except Exception:
                    with self._lock:       # leave None: caller runs default
                        self._base.eval_failures += 1
        for key, slots in misses.items():
            knob = resolved.get(key)
            if knob is None:
                continue            # unregistered subroutine: leave None
            for i in slots:
                out[i] = knob
            if record_hits and len(slots) > 1:   # duplicate keys = hits
                self._record_hit(key[0], key, len(slots) - 1)
        return out

    # -- serving accounting ---------------------------------------------------
    def record_batch(self, op: str, dims: tuple[int, ...], dtype_bytes: int,
                     backend: str, batch_size: int, *,
                     exec_seconds: float = 0.0, exec_items: int = 0,
                     queue_seconds: float = 0.0) -> None:
        """Credit one stacked execution of ``batch_size`` requests to the
        shape bucket keyed like the decision cache (serving layer hook).

        ``exec_seconds`` must cover ONLY the stacked execution span (the
        ``run_op`` call) over ``exec_items`` stacked rows; queue/linger wait
        accumulated before execution goes into ``queue_seconds``.  The
        execution-only split is what the online retuner samples — a span
        that included scheduler wait would read as model drift every time
        the batching policy lingered."""
        key = (backend, op, dtype_bytes, tuple(int(d) for d in dims))
        with self._lock:
            b = self._base.for_bucket(key)
            b.batches += 1
            b.requests += int(batch_size)
            b.max_batch = max(b.max_batch, int(batch_size))
            b.exec_seconds += float(exec_seconds)
            b.exec_items += int(exec_items)
            b.queue_seconds += float(queue_seconds)

    # -- warm-start persistence ----------------------------------------------
    def export_cache(self) -> list[dict]:
        """Decision-cache contents as JSON-safe records, LRU-oldest first,
        so a restarted server can skip the cold-start model evaluations.

        Each record carries the ``artifact_version`` of the subroutine that
        is registered for its key *now* — which is also the one that made
        the decision, because :meth:`swap` invalidates a subroutine's
        entries in the same critical section that replaces it.

        Active knob quarantines are exported too (``{"quarantine": 1, ...}``
        records, prepended, TTL rebased to *remaining* seconds): a crashing
        knob must stay benched across a warm restart, not get a fresh shot
        because the process recycled.  An attached error-budget ledger's
        rungs (``{"budget": 1, ...}`` records, first) ride along the same
        way — a rung that exhausted its budget stays skipped after a
        restart."""
        led = self._budgets
        budget_records = led.export() if led is not None else []
        with self._lock:
            self._fold_touches_locked()
            now = time.monotonic()
            out: list[dict] = budget_records + [
                {"quarantine": 1, "backend": qk[0], "op": qk[1],
                 "dtype_bytes": int(qk[2]), "knob": qk[3].dict,
                 "fallback_knob": fb.dict, "ttl_s": deadline - now}
                for qk, (deadline, fb) in self._quarantined.items()
                if deadline > now]
            out.extend(
                {"backend": k[0], "op": k[1], "dtype_bytes": int(k[2]),
                 "dims": [int(d) for d in k[3]], "knob": knob.dict,
                 "artifact_version": self._version_of(k[:3])}
                for k, knob in self._cache.items())
            return out

    def import_cache(self, entries: list[dict]) -> int:
        """Warm-start the decision cache from :meth:`export_cache` records;
        returns how many entries were imported.

        Imported decisions count as neither calls nor hits; subsequent
        ``select`` calls on these shapes are cache hits and run no model.
        Entries beyond ``cache_size`` evict in the usual LRU order.  Note
        that ``select_or_default`` still serves its default for subroutines
        with no registered model, warm cache or not.

        A persisted cache can outlive the model that produced it, two ways —
        both are dropped with a counted stat instead of replayed:

        * **generation mismatch** (``stats.import_drops_version``): the
          entry's ``artifact_version`` differs from the registered
          subroutine's — a reinstall/retune happened between persist and
          warm start, so the cached knob is the predecessor model's
          decision.  Entries with no version field (pre-versioning caches)
          are treated as version 0 and only match never-stamped artifacts.
        * **knob left the space** (``stats.import_drops_knob``): a
          recalibration changed the candidate space and the cached knob no
          longer exists in it (stale artifacts must not dictate impossible
          configs).
        * **knob under quarantine** (``stats.import_drops_quarantine``):
          quarantine records are reinstated *first* (their remaining TTL
          resumes from now; any of *our* cached decisions for the benched
          knob are evicted in the same step, preserving the
          cache-never-holds-a-quarantined-knob invariant fleet-wide), and
          any decision entry whose knob is actively quarantined is then
          dropped — a warm start must not resurrect the selection that was
          crashing when the cache was persisted.

        Entries for unregistered subroutines import as-is — there is no
        model or space to validate against yet.

        Malformed entries — wrong types, missing fields, non-dict garbage
        (a corrupted persisted payload) — are dropped and counted
        (``stats.import_drops_corrupt``), never raised: recovery from a
        damaged cache file must cost warm starts, not availability.
        ``{"budget": 1}`` records restore the attached error-budget ledger
        (parked until :meth:`attach_budgets` when none is attached yet) and
        are not counted as imported decisions.
        """
        if self._faults is not None:
            self._faults.fire("cache_import", entries=len(entries))
        budget_records = [e for e in entries
                          if isinstance(e, dict) and e.get("budget")]
        if budget_records:
            led = self._budgets
            if led is not None:
                led.import_records(budget_records)
            else:
                with self._lock:
                    self._pending_budget_records.extend(budget_records)
        n = 0
        with self._lock:
            self._fold_touches_locked()
            now = time.monotonic()
            for e in entries:
                if not isinstance(e, dict) or not e.get("quarantine"):
                    continue
                try:
                    qkey = (str(e["backend"]), str(e["op"]),
                            int(e["dtype_bytes"]),
                            Knob(tuple(sorted(e["knob"].items()))))
                    fb = Knob(tuple(sorted(e["fallback_knob"].items())))
                    self._quarantined[qkey] = (now + float(e["ttl_s"]), fb)
                    # same invariant quarantine_knob keeps: the cache never
                    # contains a quarantined knob (the hit path has no
                    # breaker check), so a peer's breaker must evict OUR
                    # cached decisions for the knob, not just gate imports
                    stale = [k for k, v in self._cache.items()
                             if k[:3] == qkey[:3] and v == qkey[3]]
                    for k in stale:
                        del self._cache[k]
                        self._cache_mirror.pop(k, None)
                except Exception:    # noqa: BLE001 — corrupt record
                    self._base.import_drops_corrupt += 1
            for e in entries:
                if not isinstance(e, dict):
                    self._base.import_drops_corrupt += 1
                    continue
                if e.get("quarantine") or e.get("budget"):
                    continue
                try:
                    key = (str(e["backend"]), str(e["op"]),
                           int(e["dtype_bytes"]),
                           tuple(int(d) for d in e["dims"]))
                    knob = Knob(tuple(sorted(e["knob"].items())))
                    version = int(e.get("artifact_version", 0))
                except Exception:    # noqa: BLE001 — corrupt record
                    self._base.import_drops_corrupt += 1
                    continue
                sub = self._subs.get(key[:3])
                if sub is not None and version != self._version_of(key[:3]):
                    self._base.import_drops_version += 1
                    continue
                space = getattr(sub, "knob_space", None)
                if space is not None and knob not in space.candidates:
                    self._base.import_drops_knob += 1
                    continue
                q = self._quarantined.get(key[:3] + (knob,))
                if q is not None and q[0] > now:
                    self._base.import_drops_quarantine += 1
                    continue
                self._cache[key] = knob
                self._cache.move_to_end(key)
                self._cache_mirror[key] = knob
                n += 1
            while len(self._cache) > self._cache_size:
                old, _ = self._cache.popitem(last=False)
                self._cache_mirror.pop(old, None)
        return n

    def absorb_journal(self, records: list[dict]) -> int:
        """Absorb a batch of shared-journal records appended by *peer*
        processes (see :class:`repro_torch.core.durable.JournalFollower`): the
        fleet-coherence path.  Semantically this is :meth:`import_cache`
        — the same version/space/quarantine drop rules apply, so a peer on
        a different artifact generation cannot pollute this cache — with
        the imports additionally counted in ``stats.journal_absorbed``.
        Idempotent: re-absorbing a record this process itself journaled
        (its own entries come back around the shared file) is a same-key
        same-knob overwrite.  Returns the number of records imported."""
        if not records:
            return 0
        n = self.import_cache(records)
        with self._lock:
            self._base.journal_absorbed += n
        return n

    def clear_cache(self) -> None:
        with self._lock:
            del self._touches[:]         # in place: hitters hold this list
            self._cache.clear()
            self._cache_mirror.clear()   # in place: readers keep their view

    def cache_len(self) -> int:
        with self._lock:
            return len(self._cache)


#: process-global runtime used by kernels.ops when none is passed explicitly
_GLOBAL: AdsalaRuntime | None = None
_GLOBAL_LOCK = threading.Lock()


def global_runtime() -> AdsalaRuntime:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = AdsalaRuntime()
        return _GLOBAL
