"""Asynchronous shape-bucketed BLAS L3 serving on top of the ADSALA runtime,
on the port's kernels (the reference package's ``serving/``: the service,
its error budgets and its fault harness).

    BlasService — submit()/call() front-end, scheduler + bounded worker pool;
                  runs on the card unless ``device="cpu"`` is given
    ServeConfig — bucket/flush knobs (max_batch, linger_ms, workers, ...)
    ServeStats  — service-level counters (per-bucket detail on the runtime)
    ErrorBudgetLedger — per-(backend, op) rolling failure budgets gating the
                  degradation ladder (over-budget rungs skip their retries)
    FaultPlan   — deterministic seeded fault injection (chaos harness); give
                  one plan to the service/runtime to drive every failure
                  path on purpose
    Retuner     — online drift-aware retraining from serving telemetry
                  (``BlasService(retuner=...)``): the kernels' device time
                  against the installed model's predictions, refit and
                  atomic hot-swap on drift
    FleetService — the service's front end over N executor processes
                  (``spawn``), each with its own runtime and CUDA context

Failure semantics: every submitted request resolves — result, or a typed
error (ServiceClosedError / DeadlineExpiredError / ExecutionFailedError);
overload is shed synchronously at submit with AdmissionRejectedError.  The
ladder has no backend rung below the requested one: ``hopper`` never
degrades onto a library call or the CPU.
"""

from .budget import BudgetConfig, ErrorBudgetLedger
from .faults import FaultPlan, FaultSpec, InjectedFault
from .fleet import ExecutorDiedError, FleetConfig, FleetService
from .retune import RetuneConfig, Retuner, RetuneStats
from .service import (AdmissionRejectedError, BlasService,
                      DeadlineExpiredError, ExecutionFailedError,
                      ServeConfig, ServeStats, ServiceClosedError, bucket_key)

__all__ = ["BlasService", "ServeConfig", "ServeStats", "bucket_key",
           "BudgetConfig", "ErrorBudgetLedger",
           "FaultPlan", "FaultSpec", "InjectedFault",
           "ServiceClosedError", "DeadlineExpiredError",
           "ExecutionFailedError", "AdmissionRejectedError",
           "Retuner", "RetuneConfig", "RetuneStats",
           "FleetConfig", "FleetService", "ExecutorDiedError"]
