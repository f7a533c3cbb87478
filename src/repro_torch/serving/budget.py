"""Per-(backend, op) error budgets for the degradation ladder (the reference
package's ``serving/budget.py``, unchanged but for this docstring).

Without budgets the ladder treats every rung as healthy until proven
otherwise *per bucket*: a backend that has been crashing for minutes still
gets its full retry schedule (attempts × exponential backoff sleeps) from every new
bucket before the ladder moves on.  Under sustained rung failure that cost
is pure waste — the outcome is already known.

An :class:`ErrorBudgetLedger` gives each ``(backend, op)`` rung a rolling
failure-rate window and a three-state breaker:

    closed     rate within budget → the rung runs its normal ladder step
    open       budget exhausted → the rung is SKIPPED outright (no
               attempts, no retries, no backoff sleeps) until the probe
               interval elapses
    half-open  probe due → exactly ONE single-attempt execution is let
               through; success closes the breaker (window cleared),
               failure re-opens it for another interval

The ledger is deliberately ignorant of the service: callers ask
:meth:`admit` before a rung and :meth:`record` after every real attempt.
State transitions happen lazily inside those two calls under one lock, and
``now`` is injectable everywhere, so chaos scenarios replay bit-for-bit.

Budget state survives restarts by riding the decision cache:
``AdsalaRuntime.attach_budgets`` hooks a ledger into ``export_cache`` /
``import_cache`` as ``{"budget": 1, ...}`` records with the open-breaker
probe timing rebased to remaining seconds — a rung that was burning its
budget when the process died stays skipped across the restart instead of
getting a free storm of retries.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

__all__ = ["BudgetConfig", "ErrorBudgetLedger"]


@dataclasses.dataclass(frozen=True)
class BudgetConfig:
    """Budget policy shared by every rung the ledger tracks."""
    window: int = 16              # rolling outcome window per (backend, op)
    threshold: float = 0.5        # failure rate that exhausts the budget
    min_count: int = 4            # outcomes required before skipping at all
    probe_interval_s: float = 5.0  # open → half-open probe cadence

    def __post_init__(self) -> None:
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if not 0.0 < self.threshold <= 1.0:
            raise ValueError("threshold must be in (0, 1]")
        if self.min_count < 1:
            raise ValueError("min_count must be >= 1")
        if self.probe_interval_s <= 0:
            raise ValueError("probe_interval_s must be > 0")


class _Rung:
    __slots__ = ("outcomes", "state", "probe_due", "probe_started",
                 "opens", "skips", "probes")

    def __init__(self, window: int) -> None:
        self.outcomes: collections.deque[bool] = \
            collections.deque(maxlen=window)
        self.state = "closed"
        self.probe_due = 0.0        # monotonic; meaningful while open
        self.probe_started = 0.0    # monotonic; meaningful while half-open
        self.opens = 0
        self.skips = 0
        self.probes = 0

    def failure_rate(self) -> float:
        n = len(self.outcomes)
        return (n - sum(self.outcomes)) / n if n else 0.0


class ErrorBudgetLedger:
    """Thread-safe rolling failure budgets keyed ``(backend, op)``."""

    def __init__(self, config: BudgetConfig | None = None) -> None:
        self.config = config if config is not None else BudgetConfig()
        self._lock = threading.Lock()
        self._rungs: dict[tuple[str, str], _Rung] = {}

    def _rung(self, backend: str, op: str) -> _Rung:
        key = (backend, op)
        rung = self._rungs.get(key)
        if rung is None:
            rung = self._rungs[key] = _Rung(self.config.window)
        return rung

    # -- the two calls the ladder makes ---------------------------------------
    def admit(self, backend: str, op: str, *,
              now: float | None = None) -> str:
        """Gate one ladder rung: ``"closed"`` (run the normal step),
        ``"probe"`` (run exactly one attempt, no retries), or ``"skip"``
        (do not execute at all)."""
        if now is None:
            now = time.monotonic()
        cfg = self.config
        with self._lock:
            rung = self._rungs.get((backend, op))
            if rung is None:
                return "closed"           # no history: innocent
            if rung.state == "closed":
                if len(rung.outcomes) >= cfg.min_count and \
                        rung.failure_rate() > cfg.threshold:
                    rung.state = "open"
                    rung.probe_due = now + cfg.probe_interval_s
                    rung.opens += 1
                    rung.skips += 1
                    return "skip"
                return "closed"
            if rung.state == "open":
                if now >= rung.probe_due:
                    rung.state = "half_open"
                    rung.probe_started = now
                    rung.probes += 1
                    return "probe"
                rung.skips += 1
                return "skip"
            # half-open: one probe is already in flight.  If its owner died
            # without recording (worker crash), reclaim after a full
            # interval instead of wedging the rung open forever.
            if now - rung.probe_started >= cfg.probe_interval_s:
                rung.probe_started = now
                rung.probes += 1
                return "probe"
            rung.skips += 1
            return "skip"

    def record(self, backend: str, op: str, ok: bool, *,
               now: float | None = None) -> None:
        """Book the outcome of one real execution attempt on a rung."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            rung = self._rung(backend, op)
            if rung.state == "half_open":
                if ok:
                    # probe succeeded: close and forgive the window — the
                    # rung starts its next budget from a clean slate
                    rung.state = "closed"
                    rung.outcomes.clear()
                    rung.outcomes.append(True)
                else:
                    rung.state = "open"
                    rung.probe_due = now + self.config.probe_interval_s
                return
            rung.outcomes.append(bool(ok))

    # -- introspection / persistence ------------------------------------------
    def snapshot(self) -> dict[tuple[str, str], dict]:
        """Per-rung view for stats surfaces: state, rolling failure rate,
        window fill, and the skip/probe/open counters."""
        with self._lock:
            return {key: {"state": r.state,
                          "failure_rate": round(r.failure_rate(), 4),
                          "window": len(r.outcomes),
                          "skips": r.skips, "probes": r.probes,
                          "opens": r.opens}
                    for key, r in sorted(self._rungs.items())}

    def export(self, *, now: float | None = None) -> list[dict]:
        """JSON-safe ``{"budget": 1, ...}`` records (export_cache shape).
        Open breakers carry ``probe_in_s`` — remaining seconds until the
        next probe — so the skip survives a restart without pinning the
        dead process's monotonic clock."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            out = []
            for (backend, op), r in sorted(self._rungs.items()):
                if not r.outcomes and r.state == "closed":
                    continue               # nothing worth persisting
                rec = {"budget": 1, "backend": backend, "op": op,
                       "outcomes": [int(o) for o in r.outcomes],
                       "state": "open" if r.state == "half_open"
                       else r.state}
                if rec["state"] == "open":
                    # a half-open breaker (probe in flight at export time)
                    # restarts with its probe due immediately
                    rec["probe_in_s"] = max(0.0, r.probe_due - now) \
                        if r.state == "open" else 0.0
                out.append(rec)
            return out

    def import_records(self, records: list[dict], *,
                       now: float | None = None) -> int:
        """Restore rungs from :meth:`export` records; malformed records are
        skipped (returns how many imported).  A restored open breaker's
        probe comes due ``probe_in_s`` seconds from *now*."""
        if now is None:
            now = time.monotonic()
        n = 0
        with self._lock:
            for rec in records:
                try:
                    if not rec.get("budget"):
                        continue
                    backend, op = str(rec["backend"]), str(rec["op"])
                    outcomes = [bool(int(o)) for o in rec.get("outcomes", [])]
                    state = str(rec.get("state", "closed"))
                    if state not in ("closed", "open"):
                        raise ValueError(state)
                    rung = self._rung(backend, op)
                    rung.outcomes.clear()
                    rung.outcomes.extend(outcomes[-self.config.window:])
                    rung.state = state
                    if state == "open":
                        rung.probe_due = now + float(
                            rec.get("probe_in_s", 0.0))
                    n += 1
                except Exception:        # noqa: BLE001 — tolerate garbage
                    continue
        return n

    def reset(self) -> None:
        with self._lock:
            self._rungs.clear()
