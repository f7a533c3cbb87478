"""Shape-bucketed asynchronous BLAS L3 serving (BLASX-style batching on top
of the ADSALA runtime) on the H100: the reference package's
``serving/service.py`` with its seams bound to the port.

What differs from the reference, seam by seam:

* backends resolve through :func:`repro_torch.backends.resolve_backend`, on
  the service's ``device`` (the backend's own, the card, unless the caller
  names one); a service whose backend has no device here raises at
  construction;
* the ladder runs on the requested backend alone: the reference steps a
  failing bucket down a chain of backends that ends in ``ref``, while here
  ``hopper`` never degrades onto the ``ref`` backend (a library call) or
  onto the CPU, so the ladder's last word is a typed
  :class:`ExecutionFailedError`; nor are stacks padded to canonical widths
  (the kernels take the batch as a grid axis, so no width recompiles);
* a bucket's operands are stacked with ``torch.stack`` (host arrays once
  per bucket, then moved by ``Backend.prepare``; tensors already on the
  device stay there), the results stay on the device and each future gets
  its row of the stacked output, a view;
* each worker launches on a CUDA stream of its own, and the execution span
  is taken from CUDA events on that stream around ``run_op``: it holds this
  bucket's kernels and the gaps the host leaves between them (``run_op``'s
  dispatch before the first launch, the gap between trsm's two), and no
  other worker's kernels.  Without a retuner a bucket books that span over
  its items, as the reference does.  With one, the span is what a
  retuner would misread (a stack of small problems runs in fewer calls'
  time than it has items, and the host's dispatch and GIL waits ride on
  an idle stream), so once per key and step
  (:meth:`~repro_torch.serving.retune.Retuner.claim_probe`) a worker probes:
  with the card to itself it runs the bucket's first item alone, once to
  warm up and then :data:`PROBE_REPEATS` times, and books the median of
  those calls' kernels (``kernels/introspect.py::launch_window``, the
  events each launcher records around its launch) as one item — the
  install's labels' own quantity (``core/timing.py``), so one call that
  the host held up between its events does not read as drift; the other
  buckets book no execution.  The worker waits on its stream before
  it resolves any future, so a resolved future holds a computed result;
* there is no trace-time decision batcher (PyTorch has no trace time); the
  concurrent cold-decision prewarm (``select_many``) stays;
* the online retuner (``serving/retune.py``) is started with the workers
  and stopped before the decision cache is persisted, as in the
  reference.

The paper's runtime (Fig. 1b) decides a knob per *single* call.  Under
serving traffic the same handful of shapes repeats across many concurrent
requests, so the profitable unit of work is the *bucket*: all pending
requests with identical ``(backend, op, dtype_bytes, dims)`` — the same key
the runtime's decision cache uses — stacked along a new leading axis and
executed as ONE call through :func:`repro_torch.kernels.ops.run_op`.  One
ML knob selection then amortises over the whole bucket, and the backend sees a
single stacked launch instead of B dispatches.

Life of a request::

    submit() ──► bucket[(backend, op, bytes, dims, extra)] ─┐
                                                            │ full (max_batch)
    scheduler thread: linger-deadline watch ────────────────┤ or aged (linger)
                                                            ▼
    ready queue ──► worker pool (bounded) ──► run_op(stacked) ──► futures

Flush policy is per bucket: a bucket flushes when it holds ``max_batch``
requests (size trigger, checked at submit) or when its oldest request has
waited ``linger_ms`` (time trigger, checked by the scheduler thread).
``max_pending`` bounds the number of in-flight requests — ``submit`` blocks
once the bound is hit, which is the service's backpressure signal.

The hot submit path stays cheap on purpose: one mutex acquisition, no
broadcast.  Workers block on the ready *queue* (not a shared condition), the
scheduler sleeps on an event it only needs when a bucket is *opened*, and
completion broadcasts fire per batch, not per request.

Failure semantics (the budget-gated degradation ladder)::

    per (backend, op): error-budget gate (serving.budget)
      ├─ closed  → the stack runs its normal ladder steps below
      ├─ open    → SKIPPED outright: no attempts, no retries, no backoff
      │            sleeps (ServeStats.budget_skips) — a backend that has
      │            been failing all minute has nothing new to say
      └─ probe   → ONE single-attempt execution; success closes the
                   breaker, failure re-opens it (ServeStats.budget_probes)

    stacked run_op crashes (once admitted)
      ├─► bounded exponential-backoff retries on the same backend/knob
      │     (each sleep capped at the bucket's earliest request deadline)
      ├─► default-knob probe — success pins the crash on the *knob*:
      │     quarantine (backend, op, dtype, knob) in the runtime (TTL'd
      │     circuit breaker) and serve the probe's result
      ├─► bisect the bucket: one poisoned request must not sink batchmates
      └─► typed ExecutionFailedError on the survivors' futures — except
          requests whose deadline lapsed during the ladder, which fail
          with DeadlineExpiredError (they timed out, the backend merely
          also happened to be broken)

Overload is shed at the front door (admission control, all knobs on
``ServeConfig``): a request whose ``deadline`` cannot be met given the
bucket's observed mean queue delay is rejected synchronously with
``AdmissionRejectedError`` instead of being parked to die; lower priority
classes (``submit(priority="batch"/"exploration")`` — bulk and
exploration traffic) shed at a fraction of ``max_pending`` while user
traffic still gets the full buffer; and past ``brownout_pending`` in-flight requests the
workers serve cached-or-default knobs only (``runtime.peek``) — zero model
evaluations until the backlog drains.

Every submitted request therefore resolves — to a result, a
``DeadlineExpiredError`` (its ``submit(deadline=)`` lapsed before
execution), an ``ExecutionFailedError`` (ladder exhausted), or a
``ServiceClosedError`` (``close()`` aborted it before execution).  Workers
are supervised: a dead worker's claimed bucket is requeued and the thread
respawned (``ServeStats.worker_respawns``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.runtime import AdsalaRuntime, global_runtime

__all__ = ["BlasService", "ServeConfig", "ServeStats", "bucket_key",
           "ServiceClosedError", "DeadlineExpiredError",
           "ExecutionFailedError", "AdmissionRejectedError"]


class ServiceClosedError(RuntimeError):
    """submit() on a closed service, or a request abandoned by close()."""


class AdmissionRejectedError(RuntimeError):
    """submit() shed this request at the front door: its deadline cannot be
    met given the bucket's observed queue delay, or its priority class is
    above its shed threshold while the service is backlogged.  Raised
    synchronously — no future is created, nothing is enqueued."""


class DeadlineExpiredError(TimeoutError):
    """The request's ``submit(deadline=)`` lapsed before execution began."""


class ExecutionFailedError(RuntimeError):
    """Terminal execution failure: every step of the degradation ladder
    (retries → default-knob probe → bisection) failed.
    The last underlying exception is chained as ``__cause__``."""

#: ops the service accepts (mirror of backends.L3_OPS)
SERVABLE_OPS = ("gemm", "symm", "syrk", "syr2k", "trmm", "trsm")

#: admission-control priority classes, in shed order: "exploration"
#: (probes, speculative traffic) sheds first, then "batch"
#: (offline/bulk callers), and "user" traffic keeps the full buffer
_PRIORITY_LEVELS = {"user": 0, "batch": 1, "exploration": 2}

#: timed calls of a probe after its warm-up, whose median it books: the
#: install timer's ``repeats`` (``core/timing.py::time_callable``)
PROBE_REPEATS = 3

#: lazily bound repro_torch.backends.resolve_backend (keeps the serving
#: module's import graph light)
_resolve_backend = None


def _backend_resolver():
    global _resolve_backend
    if _resolve_backend is None:
        from repro_torch.backends import resolve_backend
        _resolve_backend = resolve_backend
    return _resolve_backend


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Bucket/flush knobs of the serving layer."""
    backend: str = "hopper"       # default execution backend for submit()
    max_batch: int = 32           # size trigger: flush a full bucket at once
    linger_ms: float = 2.0        # time trigger: max wait of a bucket's head
    workers: int = 2              # bounded executor pool size
    max_pending: int = 1024       # backpressure: submit() blocks beyond this
    min_steal: Optional[int] = None   # smallest bucket an *idle* worker may
                                  # flush before its linger expires (work-
                                  # conserving scheduling); None = max_batch/2
    # -- resilience (the degradation ladder) --
    exec_retries: int = 1         # same-backend/knob retries after a crash
    retry_backoff_s: float = 0.005    # backoff base, doubled per retry
    bisect_failures: bool = True      # split a failing multi-request bucket
    quarantine_ttl_s: float = 30.0    # knob circuit-breaker open duration
    # -- error budgets (serving.budget: skip known-bad rungs outright) --
    error_budget: bool = True     # gate ladder rungs on rolling failure rate
    budget_window: int = 16       # outcomes per (backend, op) rolling window
    budget_threshold: float = 0.5     # failure rate that exhausts the budget
    budget_min_count: int = 4     # outcomes before a rung may be skipped
    budget_probe_interval_s: float = 5.0  # open-breaker half-open cadence
    # -- admission control (shed overload at submit, not in the queue) --
    admission_control: bool = True    # deadline-aware + priority shedding
    shed_batch_at: float = 0.9    # "batch" priority sheds at this fraction
                                  # of max_pending (user gets the full buffer)
    shed_explore_at: float = 0.6  # "exploration" (probes) sheds first
    brownout_pending: Optional[int] = None
                                  # queue depth past which workers serve
                                  # cached-or-default knobs with ZERO model
                                  # evaluations; None disables brownout

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        if self.linger_ms < 0:
            raise ValueError("linger_ms must be >= 0")
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if self.exec_retries < 0:
            raise ValueError("exec_retries must be >= 0")
        if self.retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0")
        if self.quarantine_ttl_s <= 0:
            raise ValueError("quarantine_ttl_s must be > 0")
        if self.budget_window < 1:
            raise ValueError("budget_window must be >= 1")
        if not 0.0 < self.budget_threshold <= 1.0:
            raise ValueError("budget_threshold must be in (0, 1]")
        if self.budget_min_count < 1:
            raise ValueError("budget_min_count must be >= 1")
        if self.budget_probe_interval_s <= 0:
            raise ValueError("budget_probe_interval_s must be > 0")
        if not 0.0 <= self.shed_batch_at <= 1.0:
            raise ValueError("shed_batch_at must be in [0, 1]")
        if not 0.0 <= self.shed_explore_at <= 1.0:
            raise ValueError("shed_explore_at must be in [0, 1]")
        if self.brownout_pending is not None and self.brownout_pending < 1:
            raise ValueError("brownout_pending must be >= 1 or None")


@dataclasses.dataclass
class ServeStats:
    """Service-level aggregates; per-bucket detail lives in
    ``runtime.stats.buckets`` (see :meth:`BlasService.bucket_stats`).

    End-to-end latency is split into its two phases: ``queue_sum`` is time
    spent parked in a bucket (linger/backlog — a batching-policy artifact),
    ``exec_sum`` is time inside the stacked ``run_op`` call.  The split is
    load-bearing: an online retuner compares *execution* time against the
    model's predictions, and a span that silently included scheduler wait
    would read as drift whenever the flush policy lingered.  On the card the
    execution span comes from CUDA events on the worker's own stream (see
    the module docstring for what it holds)."""
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    batches: int = 0
    max_batch: int = 0
    latency_sum: float = 0.0      # submit→result, seconds, completed only
    queue_sum: float = 0.0        # submit→execution-start (bucket wait)
    exec_sum: float = 0.0         # per-request share: its batch's exec span
    # -- resilience counters --
    retries: int = 0              # same-backend re-executions after a crash
    quarantined_knobs: int = 0    # knob circuit breakers this service opened
    deadline_expired: int = 0     # requests dropped before execution (or
                                  # expired during the ladder's retries)
    worker_respawns: int = 0      # dead workers detected and replaced
    warm_start_errors: int = 0    # registry load/save failures (survived)
    # -- error budgets (per-rung state: BlasService.budget_state()) --
    budget_skips: int = 0         # ladder rungs skipped outright (budget
                                  # exhausted: no attempts, no sleeps)
    budget_probes: int = 0        # half-open single-attempt probes let
                                  # through an open breaker
    # -- admission control --
    shed_deadline: int = 0        # submits rejected: deadline infeasible
                                  # given the bucket's mean queue delay
    shed_priority: int = 0        # batch/exploration submits rejected at
                                  # their shed fraction of max_pending
    brownout_batches: int = 0     # buckets served cached-or-default knobs
                                  # (zero model evals) under brownout
    retuner_abandoned: int = 0    # close() retuner joins that timed out
                                  # mid-refit (bounded by the close budget)

    @property
    def mean_batch(self) -> float:
        done = self.completed + self.failed
        return done / self.batches if self.batches else 0.0

    @property
    def mean_latency(self) -> float:
        return self.latency_sum / self.completed if self.completed else 0.0

    @property
    def mean_queue_latency(self) -> float:
        return self.queue_sum / self.completed if self.completed else 0.0

    @property
    def mean_exec_latency(self) -> float:
        return self.exec_sum / self.completed if self.completed else 0.0


def bucket_key(op: str, shapes: Sequence[tuple[int, ...]], dtypes,
               backend: str, extra: tuple = ()) -> tuple:
    """The grouping key: runtime decision-cache key + dtypes + scalar-kwargs.

    Requests in one bucket must be exchangeable under a single stacked call,
    so anything that changes semantics splits the bucket: the exact dtype
    *name* of every operand (itemsize alone would stack float32 with int32,
    and operand 0 alone would miss a mixed-precision second operand — both
    silently promote under a stack) and any scalar kwargs (alpha, beta) —
    two alphas never share a stack.  The first four fields remain the
    runtime decision-cache key.  ``dtypes`` may be torch or numpy dtypes:
    a torch dtype goes by its name (``torch.float32`` -> ``"float32"``),
    so a tensor and an array of one dtype share a bucket.
    """
    from repro_torch.kernels.ops import DTYPE_BYTES, dims_of
    names = tuple(_dtype_name(d) for d in dtypes)
    return (backend, op, DTYPE_BYTES(dtypes[0]),
            dims_of(op, tuple(shapes)), names, extra)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _resolve_result(fut: Future, value) -> bool:
    """Set a future's result; False if it was already resolved (a bucket
    re-executed after worker recovery must keep the first resolution)."""
    try:
        fut.set_result(value)
        return True
    except Exception:        # concurrent.futures.InvalidStateError
        return False


def _resolve_exc(fut: Future, exc: BaseException) -> bool:
    try:
        fut.set_exception(exc)
        return True
    except Exception:        # already resolved — keep the first outcome
        return False


@dataclasses.dataclass
class _Request:
    op: str
    operands: tuple
    kw: dict
    future: Future
    t_submit: float
    deadline: Optional[float] = None   # absolute monotonic; None = no limit


class _Bucket:
    __slots__ = ("key", "requests", "t_head", "recovered")

    def __init__(self, key: tuple, t_head: float) -> None:
        self.key = key
        self.requests: list[_Request] = []
        self.t_head = t_head          # monotonic enqueue time of the head
        self.recovered = 0            # times requeued after a worker death


class _CardLock:
    """The card, shared by the workers' buckets and held alone by a probe
    (a retuner's telemetry: one item's kernels with nothing else of the
    service on the card).  A waiting probe goes first: no new bucket
    starts once one is waiting."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._shared = 0
        self._waiting = 0
        self._alone = False

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            while self._alone or self._waiting:
                self._cond.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            self._waiting += 1
            while self._alone or self._shared:
                self._cond.wait()
            self._waiting -= 1
            self._alone = True
        try:
            yield
        finally:
            with self._cond:
                self._alone = False
                self._cond.notify_all()


class BlasService:
    """Asynchronous shape-bucketed BLAS front-end over an ADSALA runtime.

    ``submit`` returns a :class:`concurrent.futures.Future`; buckets are
    executed by a bounded worker pool as single stacked ``run_op`` calls.
    Pass a :class:`~repro_torch.core.registry.ModelRegistry` to warm-start
    the runtime's decision cache on startup and persist it on ``close`` — a
    restarted server then re-serves previously seen shapes with zero model
    evaluations.

    The service runs its backends on ``device``: None means each backend's
    own (``hopper``: the CUDA card), and a host without it raises here, at
    construction.  ``device="cpu"`` runs the kernels' plain versions, as
    the tests do.  Results are tensors on that device.

    Usage::

        with BlasService(runtime=rt, config=ServeConfig(max_batch=16)) as s:
            futs = [s.submit("gemm", (a, b)) for a, b in work]
            outs = [f.result(timeout=60) for f in futs]
    """

    def __init__(self, *, runtime: Optional[AdsalaRuntime] = None,
                 config: Optional[ServeConfig] = None,
                 registry=None, retuner=None, faults=None,
                 device=None) -> None:
        self.runtime = runtime if runtime is not None else global_runtime()
        self.config = config if config is not None else ServeConfig()
        self.device = None if device is None else torch.device(device)
        # no card, no service: raises before any thread starts
        _backend_resolver()(self.config.backend, device=self.device)
        self.registry = registry
        self.stats = ServeStats()
        #: optional repro_torch.serving.faults.FaultPlan (chaos harness);
        #: every site is behind an `is not None` check — disabled costs
        #: nothing
        self._faults = faults
        # error budgets: attach the ledger BEFORE the warm start so
        # persisted {"budget": 1} records land in it (a rung that was
        # burning its budget when the last process died stays skipped)
        self.budgets = None
        if self.config.error_budget:
            from repro_torch.serving.budget import (BudgetConfig,
                                                    ErrorBudgetLedger)
            existing = self.runtime.attached_budgets()
            if existing is not None:
                self.budgets = existing     # shared runtime: shared budgets
            else:
                self.budgets = ErrorBudgetLedger(BudgetConfig(
                    window=self.config.budget_window,
                    threshold=self.config.budget_threshold,
                    min_count=self.config.budget_min_count,
                    probe_interval_s=self.config.budget_probe_interval_s))
                self.runtime.attach_budgets(self.budgets)
        # crash-safe incremental persistence: every NEW cached decision and
        # quarantine is journaled beside the snapshot, so a SIGKILL between
        # save_decision_cache calls loses nothing
        if registry is not None and self.runtime.decision_journal is None:
            self.runtime.decision_journal = registry.journal_decision
        self.warm_started = 0
        if registry is not None:
            # a corrupt or missing persisted cache must not stop the server
            # from starting cold — warm start is an optimization, not a
            # dependency
            try:
                self.warm_started = registry.load_decision_cache(self.runtime)
            except Exception:        # noqa: BLE001 — cold start instead
                self.stats.warm_start_errors += 1
        # optional online feedback loop (serving.retune.Retuner): started
        # once the workers are up, stopped before the decision cache is
        # persisted on close so the saved cache reflects the final artifact
        # generations.  Omit it (the default) for reproducibility runs.
        self.retuner = retuner
        self._start()
        if self.retuner is not None:
            self.retuner.start()

    def _start(self) -> None:
        self._mutex = threading.Lock()
        self._local = threading.local()   # per-worker CUDA streams
        # with a retuner attached a probe has the card to itself
        self._card = _CardLock() if self.retuner is not None else None
        self._done = threading.Condition(self._mutex)   # batch completions
        self._buckets: dict[tuple, _Bucket] = {}
        self._ready: "queue.Queue[Optional[_Bucket]]" = queue.Queue()
        self._wake = threading.Event()    # scheduler: new bucket opened
        self._pending = 0                 # submitted, result not yet set
        self._closed = False
        # per-worker claim slots: the bucket worker i is currently holding
        # (set BEFORE any code that could die, cleared after execution) —
        # the supervisor requeues a dead worker's claimed bucket from here
        self._claims: list[Optional[_Bucket]] = \
            [None] * self.config.workers

        self._scheduler = threading.Thread(
            target=self._scheduler_loop, name="blas-serve-scheduler",
            daemon=True)
        self._workers = [
            threading.Thread(target=self._worker_main, args=(i,),
                             name=f"blas-serve-worker-{i}", daemon=True)
            for i in range(self.config.workers)]
        # workers first: the scheduler doubles as the worker supervisor and
        # must never observe a not-yet-started thread as "dead"
        for w in self._workers:
            w.start()
        self._scheduler.start()

    # -- submission -----------------------------------------------------------
    def submit(self, op: str, operands: tuple, *,
               backend: Optional[str] = None,
               deadline: Optional[float] = None,
               priority: str = "user", **kw) -> Future:
        """Enqueue one BLAS call; returns a Future resolving to its result.

        Blocks (backpressure) while ``max_pending`` requests are in flight.
        ``deadline`` (seconds from now) bounds the request's life: a request
        still waiting in a bucket when its deadline lapses is dropped before
        execution and its future fails with :class:`DeadlineExpiredError`.
        Raises :class:`ServiceClosedError` after :meth:`close`.

        Admission control (``ServeConfig.admission_control``) sheds
        overload *synchronously* with :class:`AdmissionRejectedError`
        instead of parking doomed work: a deadlined request whose bucket's
        observed mean queue delay already exceeds the deadline is rejected
        up front, and non-``"user"`` priority classes (``"batch"``, then
        ``"exploration"`` first — retuner probes and other speculative
        traffic) are rejected once the in-flight count crosses their shed
        fraction of ``max_pending``, keeping the tail of the buffer for
        user traffic.

        Operands are 2-D tensors (on any device) or array-likes; a bucket
        stacks them on the host or on their device and moves the stack to
        the service's device once.
        """
        if op not in SERVABLE_OPS:
            raise ValueError(f"unknown op {op!r}; servable: {SERVABLE_OPS}")
        if deadline is not None and deadline <= 0:
            raise ValueError("deadline must be > 0 seconds from now")
        level = _PRIORITY_LEVELS.get(priority)
        if level is None:
            raise ValueError(f"unknown priority {priority!r}; one of "
                             f"{tuple(_PRIORITY_LEVELS)}")
        operands = tuple(x if isinstance(x, torch.Tensor) else np.asarray(x)
                         for x in operands)
        if any(x.ndim != 2 for x in operands):
            raise ValueError("submit takes one 2-D problem per request; "
                             "stacking is the service's job")
        be = backend or self.config.backend
        key = bucket_key(op, [x.shape for x in operands],
                         [x.dtype for x in operands], be,
                         tuple(sorted(kw.items())))
        cfg = self.config
        if cfg.admission_control and deadline is not None:
            # deadline feasibility against the bucket's OBSERVED queue
            # delay (lock-free peek; keyed by the requested backend — the
            # same key this request will bucket under).  No history means
            # no evidence of infeasibility: admit.
            bstats = self.runtime.bucket_stats_peek(key[:4])
            if bstats is not None and bstats.requests:
                est = bstats.mean_queue
                if est > deadline:
                    with self._mutex:
                        self.stats.shed_deadline += 1
                    raise AdmissionRejectedError(
                        f"deadline {deadline:.4f}s infeasible: bucket "
                        f"{key[:4]} mean queue delay is {est:.4f}s")
        now = time.monotonic()
        req = _Request(op=op, operands=operands, kw=kw, future=Future(),
                       t_submit=now,
                       deadline=None if deadline is None else now + deadline)
        with self._mutex:
            if self._closed:
                raise ServiceClosedError("service is closed")
            if level and cfg.admission_control:
                frac = cfg.shed_batch_at if level == 1 \
                    else cfg.shed_explore_at
                if self._pending >= frac * cfg.max_pending:
                    self.stats.shed_priority += 1
                    raise AdmissionRejectedError(
                        f"{priority!r} traffic sheds at {frac:.0%} of "
                        f"max_pending ({self._pending} in flight)")
            while self._pending >= self.config.max_pending:
                self._done.wait(0.05)
                if self._closed:
                    raise ServiceClosedError("service is closed")
            self._pending += 1
            self.stats.submitted += 1
            bucket = self._buckets.get(key)
            opened = bucket is None
            if opened:
                bucket = self._buckets[key] = _Bucket(key, now)
            bucket.requests.append(req)
            if len(bucket.requests) >= self.config.max_batch:
                del self._buckets[key]
                self._ready.put(bucket)
                opened = False            # flushed already; no linger watch
        if opened:
            self._wake.set()
        return req.future

    def call(self, op: str, operands: tuple, *,
             backend: Optional[str] = None, **kw):
        """Synchronous convenience wrapper: ``submit(...).result()``."""
        return self.submit(op, operands, backend=backend, **kw).result()

    def flush(self) -> None:
        """Force every pending bucket onto the execution queue now."""
        with self._mutex:
            buckets = [self._buckets.pop(key) for key in list(self._buckets)]
        self._prewarm(buckets)
        for b in buckets:
            self._ready.put(b)

    # -- batched knob prewarm -------------------------------------------------
    def _prewarm(self, buckets: list) -> None:
        """One batched knob selection (``AdsalaRuntime.select_many``) for a
        set of buckets about to execute: all uncached decisions share a
        single fused feature-build + model-predict call instead of one
        model evaluation per bucket inside the workers.  Keys are selected
        under the backend name the executor will resolve to, so the
        workers' own selections become cache hits.  Prewarm lookups of
        already-cached keys stay out of the hit statistics
        (``record_hits=False``) — only the executors' selections count as
        traffic.  Best-effort — any failure just leaves the decisions to
        the executors."""
        if len(buckets) < 2:
            return                    # a lone bucket gains nothing
        requests = []
        for b in buckets:
            backend, op, dtype_bytes, dims = b.key[:4]
            try:
                backend = _backend_resolver()(backend,
                                              device=self.device).name
            except Exception:        # noqa: BLE001 — unresolvable backend
                continue
            requests.append((op, dims, dtype_bytes, backend))
        if len(requests) >= 2:
            try:
                self.runtime.select_many(requests, record_hits=False)
            except Exception:        # noqa: BLE001 — executors still select
                pass

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Flush and wait until no request is in flight; True on success."""
        deadline = None if timeout is None else time.monotonic() + timeout
        self.flush()
        with self._mutex:
            while self._pending > 0:
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                self._done.wait(0.05)
        return True

    # -- stats ----------------------------------------------------------------
    def bucket_stats(self) -> dict[tuple, object]:
        """Per-bucket serving stats recorded on the runtime, keyed
        ``(backend, op, dtype_bytes, dims)``."""
        return self.runtime.stats.buckets    # stats snapshots under its lock

    # -- lifecycle ------------------------------------------------------------
    def close(self, timeout: float = 30.0) -> None:
        """Drain in-flight work, persist the decision cache (when a registry
        was given), and stop the threads.  Idempotent.

        New submissions are rejected *before* the drain starts — otherwise a
        submit racing the shutdown could park a request in a bucket no
        scheduler or worker would ever flush.  Requests the drain could NOT
        finish (hung backend, dead workers past the drain timeout) are
        *failed* with :class:`ServiceClosedError`, never leaked — no caller
        blocks forever on a future the service has abandoned."""
        with self._mutex:
            if self._closed:
                return
            self._closed = True
            self._done.notify_all()
        deadline = time.monotonic() + max(0.0, timeout)
        self.drain(timeout=timeout)
        self._wake.set()
        for _ in self._workers:
            self._ready.put(None)         # worker shutdown sentinels
        # the join budget scales with the caller's close timeout: a caller
        # asking for a fast close must not wait 5 s per stuck worker — the
        # worker's bucket is reclaimed from its claim slot below instead
        join_s = min(5.0, max(0.1, timeout))
        self._scheduler.join(timeout=join_s)
        for w in self._workers:
            w.join(timeout=join_s)
        self._abort_leftovers()
        if self.retuner is not None:        # before the cache is persisted:
            # no swap may race the export — but a retuner mid-refit can
            # outlast any close budget, so the join is bounded by whatever
            # remains of the caller's timeout.  A timed-out join abandons
            # the refit *counted*, never silently: the halted thread exits
            # after its in-flight step, and its swap (if any) lands on a
            # runtime nobody serves from anymore
            remaining = max(0.1, deadline - time.monotonic())
            if not self.retuner.stop(timeout=remaining):
                with self._mutex:
                    self.stats.retuner_abandoned += 1
        if self.registry is not None:
            try:
                self.registry.save_decision_cache(self.runtime)
            except Exception:    # noqa: BLE001 — persistence is best-effort
                with self._mutex:
                    self.stats.warm_start_errors += 1

    def _abort_leftovers(self) -> None:
        """Fail (never leak) every request the drain could not finish: still
        bucketed, parked on the ready queue, or claimed by a worker that
        died without completing it."""
        leftovers: list[_Bucket] = []
        with self._mutex:
            for key in list(self._buckets):
                leftovers.append(self._buckets.pop(key))
        while True:
            try:
                b = self._ready.get_nowait()
            except queue.Empty:
                break
            if b is not None:             # drop stale worker sentinels
                leftovers.append(b)
        for i, b in enumerate(self._claims):
            if b is not None:
                self._claims[i] = None
                leftovers.append(b)
        exc = ServiceClosedError(
            "service is closed; request abandoned before execution")
        n = sum(_resolve_exc(r.future, exc)
                for b in leftovers for r in b.requests)
        if n:
            with self._mutex:
                self.stats.failed += n
                self._pending -= n
                self._done.notify_all()

    def __enter__(self) -> "BlasService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- scheduler / workers --------------------------------------------------
    def _scheduler_loop(self) -> None:
        """Linger watchdog + worker supervisor: flush buckets whose head
        request has aged out, and detect/replace dead workers (requeueing
        whatever bucket the casualty had claimed)."""
        linger = max(self.config.linger_ms / 1000.0, 1e-4)
        while not self._closed:
            self._wake.clear()
            timeout = linger
            aged = []
            with self._mutex:
                now = time.monotonic()
                for key, bucket in list(self._buckets.items()):
                    age = now - bucket.t_head
                    if age >= linger:
                        del self._buckets[key]
                        aged.append(bucket)
                    else:
                        timeout = min(timeout, linger - age)
                idle = not self._buckets
            if aged:
                # one batched decision for the whole sweep, then enqueue
                self._prewarm(aged)
                for bucket in aged:
                    self._ready.put(bucket)
            self._supervise_workers()
            # the wait is bounded even when the bucket table is idle —
            # supervision must keep running while requests sit on the ready
            # queue or inside a (possibly dying) worker
            self._wake.wait(min(timeout, 0.05) if not idle else 0.05)

    def _supervise_workers(self) -> None:
        """Replace dead workers.  The casualty's claimed bucket (its claim
        slot is set before any fallible work) is requeued so its requests
        survive the death; a bucket that keeps killing workers is failed
        after 3 recoveries instead of crash-looping the pool."""
        if self._closed:
            return
        for i, t in enumerate(self._workers):
            if t.is_alive():
                continue
            bucket = self._claims[i]
            self._claims[i] = None
            w = threading.Thread(target=self._worker_main, args=(i,),
                                 name=f"blas-serve-worker-{i}", daemon=True)
            self._workers[i] = w
            w.start()
            with self._mutex:
                self.stats.worker_respawns += 1
            if bucket is None:
                continue
            # requests the dead worker already resolved stay resolved
            bucket.requests = [r for r in bucket.requests
                               if not r.future.done()]
            bucket.recovered += 1
            if not bucket.requests:
                continue
            if bucket.recovered > 3:
                exc = ExecutionFailedError(
                    f"bucket {bucket.key[:4]} killed "
                    f"{bucket.recovered} workers; not requeueing again")
                n = sum(_resolve_exc(r.future, exc)
                        for r in bucket.requests)
                with self._mutex:
                    self.stats.failed += n
                    self._pending -= n
                    self._done.notify_all()
            else:
                self._ready.put(bucket)

    def _worker_main(self, idx: int) -> None:
        try:
            self._worker_loop(idx)
        except BaseException:    # noqa: BLE001 — a dying worker must exit
            return               # quietly; the supervisor sees the death

    def _worker_loop(self, idx: int) -> None:
        """Workers drain the ready queue; an *idle* worker steals the
        largest worthwhile pending bucket instead of waiting out its linger
        — work-conserving scheduling, so linger only delays requests while
        every worker is busy (during which the next batch accumulates
        anyway; batch size adapts to execution speed).  Buckets below
        ``min_steal`` are left to fill: a stacked launch has a fixed
        dispatch cost, so tiny early flushes would *lose* throughput."""
        min_steal = self.config.min_steal
        if min_steal is None:
            min_steal = max(1, self.config.max_batch // 2)
        claims = self._claims
        poll = 0.001
        while True:
            try:
                bucket = self._ready.get(timeout=poll)
            except queue.Empty:
                bucket, table_empty = self._steal(min_steal)
                if bucket is None:
                    # fast 1 ms polls only while partial buckets are still
                    # filling; a fully idle service backs off (new work
                    # reaches us through the queue or the linger watchdog)
                    poll = 0.05 if table_empty else 0.001
                    continue
            if bucket is None:            # shutdown sentinel
                return
            # claim BEFORE any fallible work: if this thread dies from here
            # on, the supervisor finds the bucket in the claim slot
            claims[idx] = bucket
            if self._faults is not None:
                self._faults.fire("worker", worker=idx, key=bucket.key)
            self._execute(bucket, idx)
            claims[idx] = None
            poll = 0.001

    def _steal(self, min_steal: int) -> tuple[Optional[_Bucket], bool]:
        """(largest steal-eligible bucket or None, was-the-table-empty)."""
        with self._mutex:
            if not self._buckets:
                return None, True
            key = max(self._buckets,
                      key=lambda k: len(self._buckets[k].requests))
            if len(self._buckets[key].requests) < min_steal:
                return None, False
            return self._buckets.pop(key), False

    def _execute(self, bucket: _Bucket, worker_idx: int = 0) -> None:
        """Execute one bucket: drop deadline-expired requests, then hand the
        survivors to :meth:`_dispatch` (every future resolves)."""
        now = time.monotonic()
        live, expired = [], []
        for r in bucket.requests:
            (live if r.deadline is None or now < r.deadline
             else expired).append(r)
        if expired:
            exc = DeadlineExpiredError(
                "request deadline expired before execution")
            n = sum(_resolve_exc(r.future, exc) for r in expired)
            with self._mutex:
                self.stats.deadline_expired += n
                self._pending -= n
                self._done.notify_all()
        if live:
            self._dispatch(bucket, live, worker_idx)

    def _dispatch(self, bucket: _Bucket, reqs: list,
                  worker_idx: int) -> None:
        """Execution transport seam: the in-process service runs the
        degradation ladder right here on the worker thread;
        :class:`~repro_torch.serving.fleet.FleetService` overrides this to
        ship the bucket to the executor process paired with
        ``worker_idx``."""
        self._execute_chain(bucket, reqs)

    def budget_state(self) -> dict:
        """Per-(backend, op) error-budget rung state (breaker state,
        rolling failure rate, skip/probe counters); empty when budgets are
        disabled."""
        return self.budgets.snapshot() if self.budgets is not None else {}

    def _execute_chain(self, bucket: _Bucket, reqs: list,
                       bisected: bool = False) -> None:
        """The budget-gated ladder for one stack of requests on the
        requested backend (:meth:`_ladder`); a stack it cannot serve is
        bisected (one poisoned request must not sink its batchmates), and
        what still fails gets a typed error (``DeadlineExpiredError`` for
        requests that timed out along the way, ``ExecutionFailedError`` for
        the rest).  No other backend or device is tried."""
        backend, op, _dtype_bytes, dims = bucket.key[:4]
        last_exc = self._ladder(bucket, reqs, bisected)
        if last_exc is None:
            return
        if self.config.bisect_failures and len(reqs) > 1:
            mid = (len(reqs) + 1) // 2
            self._execute_chain(bucket, reqs[:mid], bisected=True)
            self._execute_chain(bucket, reqs[mid:], bisected=True)
            return
        # requests whose deadline lapsed during the ladder report the
        # timeout, not the backend failure they never got to outlive
        now = time.monotonic()
        live, timed_out = [], []
        for r in reqs:
            (timed_out if r.deadline is not None and now >= r.deadline
             else live).append(r)
        n_exp = 0
        if timed_out:
            dexc = DeadlineExpiredError(
                "request deadline expired during the degradation ladder")
            dexc.__cause__ = last_exc
            n_exp = sum(_resolve_exc(r.future, dexc) for r in timed_out)
        exc = ExecutionFailedError(
            f"{op} bucket dims={dims} failed on backend {backend!r}")
        exc.__cause__ = last_exc
        n = sum(_resolve_exc(r.future, exc) for r in live)
        # futures resolve BEFORE the pending count drops: drain()/close()
        # promise that no request is in flight once they return
        with self._mutex:
            self.stats.failed += n
            self.stats.deadline_expired += n_exp
            self.stats.batches += 1
            self._pending -= n + n_exp
            self._done.notify_all()

    def _ladder(self, bucket: _Bucket, reqs: list,
                bisected: bool) -> Optional[Exception]:
        """One stack on its backend: the error-budget gate first (an
        over-budget backend is skipped outright, a due breaker gets one
        single-attempt probe), then bounded-backoff retries with the
        selected knob (each sleep capped at the bucket's earliest
        deadline), then a default-knob probe whose success quarantines the
        selected knob.  None once the futures are resolved, else the last
        failure."""
        backend, op, dtype_bytes, dims = bucket.key[:4]
        cfg = self.config
        ledger = self.budgets
        mode = "closed"
        # bisected halves bypass the gate: they are the diagnostic
        # subdivision of a stack that was ALREADY admitted — skipping them
        # would let the stack's own failures starve the very isolation step
        # that exonerates its healthy batchmates.  (Their outcomes still
        # feed the window, so a genuinely dead backend opens the breaker
        # for the NEXT bucket.)
        if ledger is not None and not bisected:
            mode = ledger.admit(backend, op)
            if mode == "skip":
                # budget exhausted: no attempts, no retries, no sleeps
                with self._mutex:
                    self.stats.budget_skips += 1
                return ExecutionFailedError(
                    f"backend {backend!r} skipped: error budget exhausted")
            if mode == "probe":
                with self._mutex:
                    self.stats.budget_probes += 1
        try:
            default = _backend_resolver()(
                backend, device=self.device).default_knob(op)
        except Exception as e:           # noqa: BLE001 — typed failure
            return e
        # ONE knob decision for the whole stack, under the backend's cache
        # key (exactly what run_op would have selected); under brownout
        # (past the configured backlog) cached-or-default knobs only —
        # model evaluations are pure queue delay under overload
        if cfg.brownout_pending is not None \
                and self._pending >= cfg.brownout_pending:
            knob = self.runtime.peek(op, dims, dtype_bytes, backend=backend)
            if knob is None:
                knob = default
            with self._mutex:
                self.stats.brownout_batches += 1
        else:
            knob = self.runtime.select_or_default(
                op, dims, dtype_bytes, default, backend=backend)
        # the earliest live deadline bounds every backoff sleep: a bucket
        # must never sleep through its own deadline and then report the
        # backend failure instead of the timeout
        min_deadline = min((r.deadline for r in reqs
                            if r.deadline is not None), default=None)
        last_exc: Optional[Exception] = None
        # a half-open probe gets exactly ONE attempt: the breaker is asking
        # "is it healed", not paying the full retry schedule
        attempts = 1 if mode == "probe" else cfg.exec_retries + 1
        for attempt in range(attempts):
            if attempt:
                with self._mutex:
                    self.stats.retries += 1
                sleep_s = cfg.retry_backoff_s * (1 << (attempt - 1))
                if min_deadline is not None:
                    sleep_s = min(sleep_s, min_deadline - time.monotonic())
                if sleep_s > 0:
                    time.sleep(sleep_s)
            try:
                self._run_and_resolve(bucket, reqs, knob, attempt)
            except Exception as e:       # noqa: BLE001 — next attempt
                last_exc = e
                if ledger is not None:
                    ledger.record(backend, op, False)
            else:
                if ledger is not None:
                    ledger.record(backend, op, True)
                return None
        if knob != default and mode != "probe":
            # knob-specific-failure probe: the model's pick crashed every
            # attempt — if the backend's own default config runs clean, the
            # crash is pinned on the KNOB, so quarantine it (TTL'd breaker;
            # the cached decision is invalidated in the same stroke) and
            # serve the probe's result
            try:
                self._run_and_resolve(bucket, reqs, default,
                                      cfg.exec_retries + 1)
            except Exception as e:       # noqa: BLE001 — backend-wide
                last_exc = e
                if ledger is not None:
                    ledger.record(backend, op, False)
            else:
                if ledger is not None:
                    ledger.record(backend, op, True)
                self.runtime.quarantine_knob(
                    op, dtype_bytes, backend, knob, fallback=default,
                    ttl_s=cfg.quarantine_ttl_s)
                with self._mutex:
                    self.stats.quarantined_knobs += 1
                return None
        return last_exc

    def _stream(self, device: torch.device) -> "torch.cuda.Stream":
        """The calling worker's own CUDA stream on ``device``: its buckets
        queue behind no other worker's launches."""
        streams = getattr(self._local, "streams", None)
        if streams is None:
            streams = self._local.streams = {}
        stream = streams.get(device)
        if stream is None:
            stream = streams[device] = torch.cuda.Stream(device=device)
        return stream

    def _probe(self, call, stacked: tuple, on_card: bool):
        """A bucket's first item alone: a warm-up call, then
        :data:`PROBE_REPEATS` timed calls, as the install's labels are
        measured — then the rest as one stack.  Returns the stacked result
        and a callable giving the median of the timed calls' seconds (their
        kernels' device time on the card, read once the stream is done;
        None where nothing was launched)."""
        from repro_torch.kernels.introspect import launch_window
        one = tuple(x[0] for x in stacked)
        call(one)
        if on_card:
            windows = []
            for _ in range(PROBE_REPEATS):
                with launch_window() as window:
                    head = call(one)
                windows.append(window)

            def seconds():
                times = [w.seconds() for w in windows]
                return None if None in times else float(np.median(times))
        else:
            times = []
            for _ in range(PROBE_REPEATS):
                t0 = time.perf_counter()
                head = call(one)
                times.append(time.perf_counter() - t0)

            def seconds():
                return float(np.median(times))
        rest = [call(tuple(x[1:] for x in stacked))] \
            if len(stacked[0]) > 1 else []
        return torch.cat([head[None], *rest]), seconds

    def _run_and_resolve(self, bucket: _Bucket, reqs: list, knob,
                         attempt: int) -> None:
        """One stacked execution with one explicit knob; resolves futures
        and books stats on success, raises on failure (leaving every
        future untouched for the next ladder step)."""
        from repro_torch.kernels.ops import run_op
        backend, op, dtype_bytes, dims = bucket.key[:4]
        be = _backend_resolver()(backend, device=self.device)
        on_card = be.device.type == "cuda"
        probe = self.retuner is not None \
            and self.retuner.claim_probe(bucket.key[:4])
        card = contextlib.nullcontext() if self._card is None \
            else self._card.exclusive() if probe else self._card.shared()

        def call(operands):
            return run_op(op, operands, backend=backend, device=be.device,
                          knob=knob, runtime=self.runtime, **reqs[0].kw)

        with card:
            # the stack build is accounted as queue time, not execution:
            # only the run_op span is "executing" — a retuner compares it
            # against the model's per-call predictions, and folding
            # scheduler-side work (queue wait, linger, stacking) into it
            # would read as drift
            stacked = tuple(_stack([r.operands[i] for r in reqs], be)
                            for i in range(len(reqs[0].operands)))
            if self._faults is not None:
                self._faults.fire("stacked_execute", backend=backend, op=op,
                                  dims=dims, attempt=attempt, n=len(reqs),
                                  knob=knob)
            t_exec = time.monotonic()
            if on_card:
                stream = self._stream(be.device)
                with torch.cuda.device(be.device):
                    # the operands were stacked on the current stream
                    stream.wait_stream(torch.cuda.current_stream())
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    try:
                        with torch.cuda.stream(stream):
                            start.record()
                            out, probed = self._probe(call, stacked, True) \
                                if probe else (call(stacked), None)
                            end.record()
                    finally:
                        # nothing of this bucket is in flight once it
                        # returns or raises
                        stream.synchronize()
                    # callers read the rows on the current stream: a freed
                    # result is not reused by this worker's stream before
                    # that stream is done with it
                    out.record_stream(torch.cuda.current_stream())
                    exec_span = start.elapsed_time(end) / 1e3
            else:
                out, probed = self._probe(call, stacked, False) \
                    if probe else (call(stacked), None)
                exec_span = time.monotonic() - t_exec
        # what the bucket books as its execution (module docstring)
        if self.retuner is None:
            booked, items = exec_span, len(reqs)
        else:
            booked = probed() if probed is not None else None
            booked, items = (booked, 1) if booked is not None else (0.0, 0)
        queue_span = sum(t_exec - r.t_submit for r in reqs)
        self.runtime.record_batch(op, dims, dtype_bytes, backend, len(reqs),
                                  exec_seconds=booked, exec_items=items,
                                  queue_seconds=queue_span)
        now = time.monotonic()
        resolved = 0
        latency = 0.0
        for i, r in enumerate(reqs):
            # a view of the stacked result on the device: no copy
            if _resolve_result(r.future, out[i]):
                resolved += 1
                latency += now - r.t_submit
        # futures resolve BEFORE the pending count drops: drain()/close()
        # promise that no request is in flight once they return
        with self._mutex:
            self.stats.completed += resolved
            self.stats.batches += 1
            self.stats.max_batch = max(self.stats.max_batch, len(reqs))
            self.stats.latency_sum += latency
            self.stats.queue_sum += queue_span
            self.stats.exec_sum += exec_span * resolved
            self._pending -= resolved
            self._done.notify_all()


def _stack(items: list, be) -> torch.Tensor:
    """One operand position of a bucket as one tensor on ``be``'s device:
    tensors that share a device are stacked there, anything else is
    stacked on the host; ``Backend.prepare`` then moves the stack once."""
    if all(isinstance(x, torch.Tensor) for x in items) and \
            len({x.device for x in items}) == 1:
        stacked = torch.stack(items)
    else:
        stacked = torch.stack([x.cpu() if isinstance(x, torch.Tensor)
                               else torch.as_tensor(x) for x in items])
    return be.prepare((stacked,))[0]
