"""Fault-tolerance runtime (the reference package's
``distributed/fault_tolerance.py``, pure Python and copied): preemption
handling, straggler detection and bounded retry, the glue that lets the
training loop survive a lost process or card.

Components:
  * PreemptionGuard — SIGTERM sets a flag; the train loop checkpoints and
    exits cleanly at the next step boundary (a scheduler's preemption
    notice gives a grace period of seconds).
  * StragglerDetector — EWMA of step wall-time; a step exceeding
    ``threshold × ewma`` is flagged (logged and counted: the decision logic
    is what is exercised here).
  * RetryPolicy — bounded restarts with exponential backoff; each retry
    rebuilds the training loop and restores the latest checkpoint.
"""

from __future__ import annotations

import dataclasses
import signal
import time

__all__ = ["PreemptionGuard", "StragglerDetector", "RetryPolicy"]


class PreemptionGuard:
    def __init__(self, install_handlers: bool = True) -> None:
        self._preempted = False
        self._prev = {}
        if install_handlers:
            for sig in (signal.SIGTERM,):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:   # non-main thread (tests)
                    pass

    def _handler(self, signum, frame):
        self._preempted = True

    @property
    def preempted(self) -> bool:
        return self._preempted

    def simulate(self) -> None:    # test hook
        self._preempted = True


@dataclasses.dataclass
class StragglerDetector:
    threshold: float = 3.0
    ewma_alpha: float = 0.2
    min_steps: int = 5

    _ewma: float = 0.0
    _n: int = 0
    stragglers: int = 0

    def observe(self, step_seconds: float) -> bool:
        """Feed one step time; returns True if this step straggled."""
        self._n += 1
        if self._n <= self.min_steps:
            self._ewma = (step_seconds if self._ewma == 0.0 else
                          (1 - self.ewma_alpha) * self._ewma +
                          self.ewma_alpha * step_seconds)
            return False
        is_straggler = step_seconds > self.threshold * self._ewma
        if is_straggler:
            self.stragglers += 1
        else:   # don't poison the EWMA with straggler samples
            self._ewma = (1 - self.ewma_alpha) * self._ewma + \
                self.ewma_alpha * step_seconds
        return is_straggler

    @property
    def expected_step_seconds(self) -> float:
        return self._ewma


@dataclasses.dataclass
class RetryPolicy:
    max_retries: int = 3
    backoff_base_s: float = 1.0
    backoff_cap_s: float = 60.0

    def run(self, fn, *, on_retry=None, sleep=time.sleep):
        """Run ``fn()``; on exception, back off and retry (fn re-enters via
        restore-latest, so work is never lost beyond the last checkpoint)."""
        attempt = 0
        while True:
            try:
                return fn(attempt)
            except Exception as e:      # noqa: BLE001 — deliberate catch-all
                attempt += 1
                if attempt > self.max_retries:
                    raise
                delay = min(self.backoff_base_s * 2 ** (attempt - 1),
                            self.backoff_cap_s)
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                sleep(delay)
