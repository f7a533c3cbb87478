"""Deterministic, seeded fault injection for the serving/runtime stack (the
reference package's ``serving/faults.py``; only its imports and examples
changed).

The resilience layer (execution-time backend fallback, knob quarantine,
supervised workers, retuner error recovery) is only trustworthy if every
failure path can be driven *deterministically* — waiting for a real kernel
crash or a real dead thread makes the recovery code the least-tested code in
the repo.  This module is the test double for the world being hostile:

    plan = FaultPlan([FaultSpec(site="stacked_execute", times=2,
                                match=lambda ctx: ctx["backend"] == "hopper")])
    rt  = AdsalaRuntime(faults=plan)
    svc = BlasService(runtime=rt, faults=plan, ...)

Components that take a plan call ``plan.fire(site, **ctx)`` at named *sites*;
the plan decides — under its own lock, deterministically — whether that
occurrence raises an injected exception, sleeps an injected latency, or does
nothing.  A component constructed without a plan (the default everywhere)
holds ``None`` and guards every site with an attribute check, so the
disabled path costs one ``is not None`` test and allocates nothing.

Named sites (the contract between the chaos harness and the stack):

    ``stacked_execute``  BlasService bucket execution, per ladder attempt
                         (ctx: backend, op, dims, attempt, n = stack size,
                         knob — the port adds the knob, since its run_op
                         has no kernel_execute site)
    ``kernel_execute``   the reference's kernels.ops.run_op dispatch, after
                         knob resolution (ctx: backend, op, stacked, knob);
                         the port's run_op has no fault site
    ``predictor_eval``   AdsalaRuntime miss-path model evaluation
                         (ctx: backend, op, dtype_bytes, dims — and ``n``
                         for the batched select_many evaluation)
    ``cache_import``     AdsalaRuntime.import_cache (ctx: entries)
    ``artifact_load``    ModelRegistry per-artifact load (ctx: path)
    ``worker``           BlasService worker loop, after a bucket is claimed
                         but before it executes (ctx: worker, key) — an
                         injected raise here kills the worker thread with
                         the bucket claimed, exactly the death the
                         supervisor must recover from
    ``retuner_observe``  Retuner.observe entry (ctx: none); the retuner is
                         not ported yet
    ``retuner_refit``    Retuner.retune, before the refit (ctx: sub_key)
    ``snapshot_write``   core.durable atomic snapshot writers, before the
                         temp file is created (ctx: path, size).  A plain
                         raise models a crash *before* the write (the old
                         snapshot survives untouched); an injected latency
                         holds the writer mid-write (the recovery bench
                         SIGKILLs the process inside this window); raising
                         :class:`TornWrite` persists a truncated payload at
                         the final path before propagating
    ``journal_append``   core.durable journal appends, before the write
                         (ctx: path, size); TornWrite tears the record at
                         a seeded fraction of its bytes

Matching is by site name, then an optional ``match(ctx) -> bool`` predicate
over the site's context dict, then the occurrence window (``after`` skipped
occurrences, then ``times`` firings — ``None`` = fire forever), then an
optional seeded Bernoulli ``p``.  Everything a spec decides is a function of
the plan's seed and the deterministic occurrence order, so a chaos scenario
replays bit-for-bit.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable, Optional

__all__ = ["FaultSpec", "FaultPlan", "InjectedFault", "TornWrite"]


def __getattr__(name: str):
    # lazy re-export: TornWrite lives in core.durable (the layer that has
    # to catch it), and importing it eagerly would drag the whole heavy
    # core package into this module's deliberately light import graph
    if name == "TornWrite":
        from repro_torch.core.durable import TornWrite
        return TornWrite
    raise AttributeError(name)


class InjectedFault(RuntimeError):
    """Default exception raised at a firing site (chaos-only by design:
    nothing in the production stack raises or catches it specially, so an
    injected fault exercises exactly the generic failure paths)."""


@dataclasses.dataclass
class FaultSpec:
    """One injection rule: *where* (site + match), *when* (after/times/p),
    and *what* (an exception and/or added latency)."""
    site: str
    #: exception to raise: a class (instantiated per firing with a
    #: descriptive message) or an instance (raised as-is).  None = no raise
    #: (latency-only fault).
    exc: type[BaseException] | BaseException | None = InjectedFault
    #: seconds to sleep before raising (or returning, for latency-only)
    latency_s: float = 0.0
    #: predicate over the site's context dict; None matches every occurrence
    match: Optional[Callable[[dict], bool]] = None
    #: fire on at most this many matching occurrences (None = forever)
    times: Optional[int] = 1
    #: skip this many matching occurrences before the first firing
    after: int = 0
    #: Bernoulli firing probability, drawn from the plan's seeded stream
    p: float = 1.0

    # runtime counters (owned by the plan, mutated under its lock)
    seen: int = 0
    fired: int = 0

    def __post_init__(self) -> None:
        if self.times is not None and self.times < 0:
            raise ValueError("times must be >= 0 or None")
        if self.after < 0:
            raise ValueError("after must be >= 0")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError("p must be in [0, 1]")
        if self.exc is None and self.latency_s <= 0.0:
            raise ValueError("a spec must inject an exception or latency")


class FaultPlan:
    """A deterministic, thread-safe set of :class:`FaultSpec` rules.

    The decision of whether an occurrence fires is taken under the plan's
    lock (counters and the seeded RNG advance atomically), so concurrent
    workers hitting the same spec observe one global occurrence order; the
    injected latency sleep happens *outside* the lock so a slow fault never
    serialises unrelated sites.
    """

    def __init__(self, specs: tuple | list = (), *, seed: int = 0) -> None:
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._specs: list[FaultSpec] = []
        #: audit log of firings: (site, spec index, context summary)
        self.log: list[tuple[str, int, dict]] = []
        for s in specs:
            self.add(s)

    def add(self, spec: FaultSpec) -> FaultSpec:
        with self._lock:
            self._specs.append(spec)
        return spec

    def specs(self, site: str | None = None) -> list[FaultSpec]:
        with self._lock:
            return [s for s in self._specs
                    if site is None or s.site == site]

    def fired(self, site: str | None = None) -> int:
        """Total firings (optionally per site) — scenario assertions."""
        with self._lock:
            return sum(s.fired for s in self._specs
                       if site is None or s.site == site)

    def reset(self) -> None:
        """Rewind every counter and the RNG to the initial state."""
        with self._lock:
            self._rng = random.Random(self.seed)
            self.log.clear()
            for s in self._specs:
                s.seen = 0
                s.fired = 0

    # -- the hook -------------------------------------------------------------
    def fire(self, site: str, **ctx: Any) -> None:
        """Called by instrumented components at a named site.  Applies the
        first matching armed spec: sleeps its latency, then raises its
        exception (if any).  A non-matching occurrence returns immediately.
        """
        sleep_s = 0.0
        raise_exc: BaseException | None = None
        with self._lock:
            for i, s in enumerate(self._specs):
                if s.site != site:
                    continue
                if s.match is not None and not s.match(ctx):
                    continue
                s.seen += 1
                if s.seen <= s.after:
                    continue
                if s.times is not None and s.fired >= s.times:
                    continue
                if s.p < 1.0 and self._rng.random() >= s.p:
                    continue
                s.fired += 1
                self.log.append((site, i, {k: v for k, v in ctx.items()
                                           if isinstance(v, (str, int, float,
                                                             bool, tuple))}))
                sleep_s = s.latency_s
                if s.exc is not None:
                    raise_exc = s.exc if isinstance(s.exc, BaseException) \
                        else s.exc(f"injected fault at {site!r} "
                                   f"(spec {i}, firing {s.fired})")
                break
        if sleep_s > 0.0:
            time.sleep(sleep_s)
        if raise_exc is not None:
            raise raise_exc
