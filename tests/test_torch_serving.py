"""The port's shape-bucketed ``BlasService`` on the CPU (``device="cpu"``: the
kernels' plain versions), held against the reference package's
``BlasService`` on the same seeded requests and against a float64 oracle
(max relative error 5e-4, the reference conformance harness's float32
limit); its flush policy, admission control, brownout, error budgets and
the degradation ladder under ``FaultPlan``-injected crashes, where the
ladder runs on the requested backend alone.  Every wait on a future has a
timeout, so no test can hang the suite."""

import time

import numpy as np
import pytest
import torch

import repro.serving as ref_serving
from repro.core import AdsalaRuntime as RefRuntime
from repro_torch.backends import RefBackend, resolve_backend
from repro_torch.backends.conformance import oracle
from repro_torch.core import AdsalaRuntime
from repro_torch.kernels import ops
from repro_torch.serving import (AdmissionRejectedError, BlasService,
                                 DeadlineExpiredError, ExecutionFailedError,
                                 FaultPlan, FaultSpec, InjectedFault,
                                 ServeConfig, ServiceClosedError, bucket_key)
from repro_torch.serving.service import SERVABLE_OPS

#: float32 limit of the reference conformance harness
TOL = 5e-4
#: seconds any one future may take here before the test fails
WAIT = 60
#: a linger no test outlasts: the ladder tests that need their requests in
#: one stack flush it by size (max_batch), not by a 1 ms linger that a
#: loaded host can let run out after the first submit
ONE_STACK_LINGER_MS = 60_000.0

DIMS = {"gemm": (48, 32, 40), "symm": (48, 40), "syrk": (48, 32),
        "syr2k": (48, 32), "trmm": (48, 40), "trsm": (48, 40)}


def make(op, dims, seed=0):
    """Seeded float32 numpy operands of ``op`` (trsm's A made diagonally
    dominant), the shapes both packages' services take."""
    rng = np.random.default_rng(seed)
    if op == "gemm":
        m, k, n = dims
        shapes = ((m, k), (k, n))
    elif op in ("symm", "trmm", "trsm"):
        m, n = dims
        shapes = ((m, m), (m, n))
    else:
        shapes = (dims,) * (1 if op == "syrk" else 2)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if op == "trsm":
        xs[0] += dims[0] * np.eye(dims[0], dtype=np.float32)
    return tuple(xs)


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def cpu_cfg(**kw):
    base = dict(max_batch=8, linger_ms=2.0, workers=2)
    base.update(kw)
    return ServeConfig(**base)


class FixedSub:
    """Stub subroutine whose model always selects one fixed knob."""

    def __init__(self, knob, op="gemm", backend="hopper", dtype_bytes=4):
        self.backend, self.op, self.dtype_bytes = backend, op, dtype_bytes
        self.knob = knob
        self.artifact_version = 0
        self.evals = 0

    def select(self, dims):
        self.evals += 1
        return self.knob


def _knobs(op="gemm"):
    """(default knob, one non-default knob) of ``op`` on hopper."""
    default = ops.default_knob(op)
    other = next(k for k in ops.knob_space_for(op) if k != default)
    return default, other


# ---------------------------------------------------------------------------
# configuration, keys, binding
# ---------------------------------------------------------------------------

def test_serve_config_defaults_and_validation():
    assert ServeConfig().backend == "hopper"
    for bad in (dict(max_batch=0), dict(workers=0), dict(linger_ms=-1),
                dict(max_pending=0), dict(exec_retries=-1),
                dict(budget_window=0), dict(budget_threshold=0.0),
                dict(shed_batch_at=1.5), dict(brownout_pending=0)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)


def test_bucket_key_maps_torch_dtypes_to_names():
    shapes = [(48, 32), (32, 40)]
    base = bucket_key("gemm", shapes, [np.float32] * 2, "hopper")
    assert base == ("hopper", "gemm", 4, (48, 32, 40),
                    ("float32", "float32"), ())
    assert bucket_key("gemm", shapes, [torch.float32] * 2, "hopper") == base
    assert bucket_key("gemm", shapes, [torch.float64] * 2, "hopper") != base
    assert bucket_key("gemm", shapes, [torch.int32] * 2, "hopper") != base
    assert bucket_key("gemm", shapes, [np.float32, torch.float64],
                      "hopper") != base
    assert bucket_key("trmm", [(48, 48), (48, 40)], [torch.float32] * 2,
                      "hopper")[3] == (48, 40)


def test_service_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlasService(runtime=AdsalaRuntime())
    with BlasService(runtime=AdsalaRuntime(), config=cpu_cfg(workers=1),
                     device="cpu") as svc:
        out = svc.submit("gemm", make("gemm", (8, 8, 8))).result(WAIT)
    assert out.device.type == "cpu"


def test_degradation_chain_has_no_rung_below_hopper():
    """A bucket that fails on its backend every time is tried on that
    backend alone: never on ``ref`` (a library call) or another device."""
    for backend in ("hopper", "ref"):
        seen = []
        plan = FaultPlan([FaultSpec(site="stacked_execute", times=None,
                                    match=lambda c: seen.append(
                                        c["backend"]) or True)])
        cfg = cpu_cfg(backend=backend, max_batch=1, linger_ms=0.5,
                      workers=1, min_steal=1, exec_retries=1,
                      retry_backoff_s=0.0, error_budget=False)
        with BlasService(runtime=AdsalaRuntime(), config=cfg, faults=plan,
                         device="cpu") as svc:
            with pytest.raises(ExecutionFailedError, match=backend):
                svc.submit("gemm", make("gemm", (16, 16, 16))).result(WAIT)
        assert seen == [backend, backend]          # attempt + retry only
        assert svc.stats.failed == 1


# ---------------------------------------------------------------------------
# results against the reference service and float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", SERVABLE_OPS)
def test_service_matches_reference_service(op):
    reqs = [make(op, DIMS[op], seed=i) for i in range(6)]
    kw = {"alpha": 0.5}
    with BlasService(runtime=AdsalaRuntime(), config=cpu_cfg(),
                     device="cpu") as svc:
        futs = [svc.submit(op, r, **kw) for r in reqs]
        outs = [f.result(WAIT) for f in futs]
    with ref_serving.BlasService(runtime=RefRuntime(), config=ref_serving
                                 .ServeConfig(backend="ref", max_batch=8,
                                              linger_ms=2.0)) as ref_svc:
        ref_outs = [np.asarray(f.result(WAIT)) for f in
                    [ref_svc.submit(op, r, **kw) for r in reqs]]
    assert svc.stats.completed == 6 and svc.stats.failed == 0
    for r, out, ref_out in zip(reqs, outs, ref_outs):
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        want = oracle(op, r, **kw)
        assert rel(out.numpy(), want) < TOL
        assert rel(ref_out, want) < TOL
        assert rel(out.numpy(), ref_out.astype(np.float64)) < TOL


def test_mixed_traffic_from_threads_round_trips():
    import concurrent.futures
    with BlasService(runtime=AdsalaRuntime(), config=cpu_cfg(workers=3),
                     device="cpu") as svc:
        def client(t):
            got = []
            for i in range(12):
                op = SERVABLE_OPS[i % len(SERVABLE_OPS)]
                operands = make(op, DIMS[op], seed=100 * t + i)
                got.append((op, operands, svc.submit(op, operands)))
            return got
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            cases = [c for part in pool.map(client, range(4)) for c in part]
        for op, operands, fut in cases:
            assert rel(fut.result(WAIT).numpy(), oracle(op, operands)) < TOL
    assert svc.stats.completed == 48 and svc.stats.failed == 0
    assert svc.stats.mean_batch >= 1.0


def test_stacked_bucket_equals_run_op_on_the_stack():
    reqs = [make("trmm", DIMS["trmm"], seed=i) for i in range(4)]
    cfg = cpu_cfg(max_batch=4, linger_ms=60_000.0, min_steal=4, workers=1)
    with BlasService(runtime=AdsalaRuntime(), config=cfg,
                     device="cpu") as svc:
        outs = [f.result(WAIT) for f in
                [svc.submit("trmm", r, alpha=2.0) for r in reqs]]
    stacked = tuple(torch.from_numpy(np.stack([r[i] for r in reqs]))
                    for i in range(2))
    want = ops.run_op("trmm", stacked, device="cpu", alpha=2.0)
    for i, out in enumerate(outs):
        assert torch.equal(out, want[i])
        assert out._base is not None       # a row of the stack, not a copy


def test_tensor_and_array_operands_share_a_bucket():
    a, b = make("gemm", (16, 16, 16), seed=1)
    cfg = cpu_cfg(max_batch=2, linger_ms=60_000.0, min_steal=2, workers=1)
    with BlasService(runtime=AdsalaRuntime(), config=cfg,
                     device="cpu") as svc:
        f1 = svc.submit("gemm", (a, b))
        f2 = svc.submit("gemm", (torch.from_numpy(a), torch.from_numpy(b)))
        assert torch.equal(f1.result(WAIT), f2.result(WAIT))
    assert svc.stats.batches == 1


# ---------------------------------------------------------------------------
# flush policy
# ---------------------------------------------------------------------------

def test_full_bucket_flushes_as_one_batch():
    rt = AdsalaRuntime()
    cfg = cpu_cfg(max_batch=8, linger_ms=60_000.0, min_steal=8)
    with BlasService(runtime=rt, config=cfg, device="cpu") as svc:
        futs = [svc.submit("gemm", make("gemm", (32, 32, 32), seed=i))
                for i in range(8)]
        for f in futs:
            f.result(WAIT)        # resolves without any linger expiry
        assert svc.stats.batches == 1 and svc.stats.max_batch == 8
        b = svc.bucket_stats()[("hopper", "gemm", 4, (32, 32, 32))]
        assert (b.batches, b.requests, b.max_batch) == (1, 8, 8)
    assert rt.stats.calls == 1    # ONE knob decision for all 8 requests


def test_size_trigger_splits_a_burst_into_full_buckets():
    cfg = cpu_cfg(max_batch=4, linger_ms=60_000.0, min_steal=4, workers=1)
    with BlasService(runtime=AdsalaRuntime(), config=cfg,
                     device="cpu") as svc:
        futs = [svc.submit("syrk", make("syrk", (24, 16), seed=i))
                for i in range(12)]
        for f in futs:
            f.result(WAIT)
    assert svc.stats.batches == 3 and svc.stats.max_batch == 4
    assert svc.stats.mean_batch == 4.0


def test_linger_flushes_partial_bucket():
    cfg = cpu_cfg(max_batch=1000, linger_ms=30.0)
    with BlasService(runtime=AdsalaRuntime(), config=cfg,
                     device="cpu") as svc:
        futs = [svc.submit("gemm", make("gemm", (32, 32, 32), seed=i))
                for i in range(3)]
        for f in futs:
            f.result(WAIT)
        assert svc.stats.batches == 1 and svc.stats.completed == 3


def test_hopper_stacks_are_never_padded():
    """A bucket of 3 runs as a stack of 3 rows, not of a canonical
    power-of-two width."""
    cfg = cpu_cfg(max_batch=16, linger_ms=10.0)
    with BlasService(runtime=AdsalaRuntime(), config=cfg,
                     device="cpu") as svc:
        for f in [svc.submit("gemm", make("gemm", (32, 32, 32), seed=i))
                  for i in range(3)]:
            f.result(WAIT)
        b = svc.bucket_stats()[("hopper", "gemm", 4, (32, 32, 32))]
    assert b.requests == 3 and b.exec_items == 3
    assert not hasattr(cfg, "pad_batches")


def test_scalar_kwargs_get_their_own_bucket():
    operands = make("gemm", (32, 32, 32), seed=1)
    with BlasService(runtime=AdsalaRuntime(), config=cpu_cfg(linger_ms=10.0),
                     device="cpu") as svc:
        f1 = svc.submit("gemm", operands)
        f2 = svc.submit("gemm", operands, alpha=2.0)
        r1, r2 = f1.result(WAIT), f2.result(WAIT)
    assert svc.stats.batches == 2
    assert torch.allclose(2.0 * r1, r2, rtol=1e-5)


def test_submit_validation_and_close():
    svc = BlasService(runtime=AdsalaRuntime(), config=cpu_cfg(workers=1),
                      device="cpu")
    with pytest.raises(ValueError, match="unknown op"):
        svc.submit("herk", make("gemm", (4, 4, 4)))
    with pytest.raises(ValueError, match="2-D"):
        svc.submit("gemm", tuple(x[None] for x in make("gemm", (4, 4, 4))))
    with pytest.raises(ValueError, match="deadline"):
        svc.submit("gemm", make("gemm", (4, 4, 4)), deadline=0)
    with pytest.raises(ValueError, match="priority"):
        svc.submit("gemm", make("gemm", (4, 4, 4)), priority="vip")
    svc.close()
    with pytest.raises(ServiceClosedError):
        svc.submit("gemm", make("gemm", (4, 4, 4)))
    svc.close()                   # idempotent


# ---------------------------------------------------------------------------
# the degradation ladder under injected faults
# ---------------------------------------------------------------------------

def test_transient_crash_is_retried_on_the_same_backend():
    seen = []
    plan = FaultPlan([FaultSpec(site="stacked_execute", times=1,
                                match=lambda c: seen.append(
                                    c["backend"]) or True)])
    cfg = cpu_cfg(max_batch=2, linger_ms=ONE_STACK_LINGER_MS, workers=1,
                  min_steal=2, exec_retries=1, retry_backoff_s=0.0)
    reqs = [make("gemm", (16, 16, 16), seed=i) for i in range(2)]
    with BlasService(runtime=AdsalaRuntime(), config=cfg, faults=plan,
                     device="cpu") as svc:
        outs = [f.result(WAIT) for f in
                [svc.submit("gemm", r) for r in reqs]]
    assert plan.fired("stacked_execute") == 1
    assert svc.stats.retries == 1 and svc.stats.completed == 2
    assert seen == ["hopper", "hopper"]           # served on hopper
    for r, out in zip(reqs, outs):
        assert rel(out.numpy(), oracle("gemm", r)) < TOL


def test_knob_crash_is_quarantined_and_served_by_the_default_probe():
    default, bad = _knobs("gemm")
    plan = FaultPlan([FaultSpec(site="stacked_execute", times=None,
                                match=lambda c: c["knob"] == bad)])
    rt = AdsalaRuntime()
    rt.register(FixedSub(bad))
    cfg = cpu_cfg(max_batch=2, linger_ms=ONE_STACK_LINGER_MS, workers=1,
                  min_steal=2, exec_retries=1, retry_backoff_s=0.0,
                  quarantine_ttl_s=60.0)
    reqs = [make("gemm", (16, 16, 16), seed=i) for i in range(2)]
    with BlasService(runtime=rt, config=cfg, faults=plan,
                     device="cpu") as svc:
        outs = [f.result(WAIT) for f in
                [svc.submit("gemm", r) for r in reqs]]
    assert plan.fired("stacked_execute") == 2     # the knob, twice
    assert svc.stats.quarantined_knobs == 1 and svc.stats.failed == 0
    assert rt.stats.buckets[("hopper", "gemm", 4, (16, 16, 16))].requests \
        == 2                                       # served on hopper
    assert rt.is_quarantined("gemm", 4, "hopper", bad)
    assert rt.peek("gemm", (16, 16, 16), 4, backend="hopper") is None
    assert rt.select("gemm", (16, 16, 16), 4, backend="hopper") == default
    for r, out in zip(reqs, outs):
        assert rel(out.numpy(), oracle("gemm", r)) < TOL


def test_persistent_crash_bisects_then_fails_typed_and_never_runs_ref(
        monkeypatch):
    ref_calls = []
    real = RefBackend.execute
    monkeypatch.setattr(RefBackend, "execute", lambda self, *a, **k: (
        ref_calls.append(a), real(self, *a, **k))[1])
    seen = []
    plan = FaultPlan([FaultSpec(site="stacked_execute", times=None,
                                match=lambda c: seen.append(
                                    (c["backend"], c["n"])) or True)])
    cfg = cpu_cfg(max_batch=4, linger_ms=ONE_STACK_LINGER_MS, workers=1,
                  min_steal=4, exec_retries=0, retry_backoff_s=0.0,
                  error_budget=False)
    with BlasService(runtime=AdsalaRuntime(), config=cfg, faults=plan,
                     device="cpu") as svc:
        futs = [svc.submit("trmm", make("trmm", (16, 16), seed=i))
                for i in range(4)]
        for f in futs:
            with pytest.raises(ExecutionFailedError) as ei:
                f.result(WAIT)
            assert isinstance(ei.value.__cause__, InjectedFault)
    assert {b for b, _ in seen} == {"hopper"}     # no rung below hopper
    assert sorted({n for _, n in seen}) == [1, 2, 4]   # bisected to singles
    assert not ref_calls
    assert svc.stats.failed == 4 and svc.stats.completed == 0


def test_bisection_isolates_a_poisoned_stack():
    plan = FaultPlan([FaultSpec(site="stacked_execute", times=None,
                                match=lambda c: c["n"] > 1)])
    cfg = cpu_cfg(max_batch=4, linger_ms=ONE_STACK_LINGER_MS, workers=1,
                  min_steal=4, exec_retries=0, retry_backoff_s=0.0)
    reqs = [make("symm", (16, 16), seed=i) for i in range(4)]
    with BlasService(runtime=AdsalaRuntime(), config=cfg, faults=plan,
                     device="cpu") as svc:
        outs = [f.result(WAIT) for f in
                [svc.submit("symm", r) for r in reqs]]
    assert svc.stats.failed == 0 and svc.stats.completed == 4
    for r, out in zip(reqs, outs):
        want = ops.run_op("symm", tuple(map(torch.from_numpy, r)),
                          device="cpu")
        assert torch.equal(out, want)


def test_over_budget_rung_is_skipped_without_attempts():
    plan = FaultPlan([FaultSpec(site="stacked_execute", times=None)])
    cfg = cpu_cfg(max_batch=1, linger_ms=0.5, workers=1, min_steal=1,
                  exec_retries=1, retry_backoff_s=0.0, budget_window=8,
                  budget_threshold=0.4, budget_min_count=2,
                  budget_probe_interval_s=60.0)
    with BlasService(runtime=AdsalaRuntime(), config=cfg, faults=plan,
                     device="cpu") as svc:
        with pytest.raises(ExecutionFailedError):
            svc.submit("gemm", make("gemm", (16, 16, 16))).result(WAIT)
        fired = plan.fired("stacked_execute")
        assert fired == 2                          # attempt + retry
        for i in range(3):
            with pytest.raises(ExecutionFailedError, match="on backend"):
                svc.submit("gemm", make("gemm", (16, 16, 16),
                                        seed=i + 1)).result(WAIT)
        assert plan.fired("stacked_execute") == fired   # zero new attempts
        assert svc.stats.budget_skips == 3
        assert svc.budget_state()[("hopper", "gemm")]["state"] == "open"


def test_worker_death_recovers_without_request_loss():
    plan = FaultPlan([FaultSpec(site="worker", times=1)])
    cfg = cpu_cfg(max_batch=4, linger_ms=1.0, workers=2, min_steal=4)
    reqs = [make("syr2k", (16, 12), seed=i) for i in range(4)]
    with BlasService(runtime=AdsalaRuntime(), config=cfg, faults=plan,
                     device="cpu") as svc:
        outs = [f.result(WAIT) for f in
                [svc.submit("syr2k", r) for r in reqs]]
    assert plan.fired("worker") == 1 and svc.stats.worker_respawns >= 1
    assert svc.stats.completed == 4 and svc.stats.failed == 0
    for r, out in zip(reqs, outs):
        assert rel(out.numpy(), oracle("syr2k", r)) < TOL


def test_close_fails_stuck_requests_instead_of_leaking():
    plan = FaultPlan([FaultSpec(site="stacked_execute", exc=None,
                                latency_s=1.5)])
    cfg = cpu_cfg(max_batch=1, linger_ms=1.0, workers=1)
    svc = BlasService(runtime=AdsalaRuntime(), config=cfg, faults=plan,
                      device="cpu")
    fut = svc.submit("gemm", make("gemm", (16, 16, 16)))
    time.sleep(0.3)               # let the worker claim and stall
    svc.close(timeout=0.2)
    with pytest.raises(ServiceClosedError):
        fut.result(timeout=5.0)
    assert svc.stats.failed == 1
    for w in svc._workers:
        w.join(timeout=5.0)
    assert svc.stats.completed == 0


# ---------------------------------------------------------------------------
# deadlines, admission control, brownout
# ---------------------------------------------------------------------------

def test_deadline_expires_waiting_request_only():
    cfg = cpu_cfg(max_batch=8, linger_ms=150.0, workers=1, min_steal=8)
    operands = make("gemm", (16, 16, 16))
    with BlasService(runtime=AdsalaRuntime(), config=cfg,
                     device="cpu") as svc:
        f_dead = svc.submit("gemm", operands, deadline=0.01)
        f_live = svc.submit("gemm", operands)
        with pytest.raises(DeadlineExpiredError):
            f_dead.result(WAIT)
        f_live.result(WAIT)
    assert svc.stats.deadline_expired == 1 and svc.stats.completed == 1


def test_priority_sheds_before_user_traffic():
    plan = FaultPlan([FaultSpec(site="stacked_execute", exc=None,
                                latency_s=0.25, times=None)])
    cfg = cpu_cfg(max_batch=1, linger_ms=0.5, workers=1, min_steal=1,
                  max_pending=8, shed_explore_at=0.25, shed_batch_at=0.5)
    with BlasService(runtime=AdsalaRuntime(), config=cfg, faults=plan,
                     device="cpu") as svc:
        futs = [svc.submit("gemm", make("gemm", (16, 16, 16), seed=i))
                for i in range(4)]
        with pytest.raises(AdmissionRejectedError, match="exploration"):
            svc.submit("gemm", make("gemm", (16, 16, 16)),
                       priority="exploration")
        with pytest.raises(AdmissionRejectedError, match="batch"):
            svc.submit("gemm", make("gemm", (16, 16, 16)), priority="batch")
        futs.append(svc.submit("gemm", make("gemm", (16, 16, 16), seed=9)))
        for f in futs:
            f.result(WAIT)
        assert svc.stats.shed_priority == 2 and svc.stats.failed == 0


def test_deadline_infeasible_request_is_shed_at_submit():
    rt = AdsalaRuntime()
    rt.record_batch("gemm", (16, 16, 16), 4, "hopper", 1,
                    queue_seconds=0.5, exec_items=1)
    cfg = cpu_cfg(max_batch=1, linger_ms=0.5, workers=1, min_steal=1)
    with BlasService(runtime=rt, config=cfg, device="cpu") as svc:
        with pytest.raises(AdmissionRejectedError, match="infeasible"):
            svc.submit("gemm", make("gemm", (16, 16, 16)), deadline=0.05)
        assert svc.stats.shed_deadline == 1
        svc.submit("gemm", make("gemm", (16, 16, 16)),
                   deadline=30.0).result(WAIT)
        svc.submit("gemm", make("gemm", (32, 32, 32)),
                   deadline=0.05).result(WAIT)     # no history: admitted


def test_brownout_serves_without_model_evals():
    rt = AdsalaRuntime()
    sub = FixedSub(ops.default_knob("gemm"))
    rt.register(sub)
    cfg = cpu_cfg(max_batch=1, linger_ms=0.5, workers=1, min_steal=1,
                  brownout_pending=1)
    reqs = [make("gemm", (16, 16, 16), seed=i) for i in range(4)]
    with BlasService(runtime=rt, config=cfg, device="cpu") as svc:
        outs = [f.result(WAIT) for f in
                [svc.submit("gemm", r) for r in reqs]]
        assert svc.stats.brownout_batches >= 1 and svc.stats.failed == 0
    assert sub.evals == 0 and rt.stats.model_evals == 0
    for r, out in zip(reqs, outs):
        assert rel(out.numpy(), oracle("gemm", r)) < TOL
    rt2 = AdsalaRuntime()
    sub2 = FixedSub(ops.default_knob("gemm"))
    rt2.register(sub2)
    with BlasService(runtime=rt2, config=cpu_cfg(
            max_batch=1, linger_ms=0.5, workers=1, min_steal=1),
            device="cpu") as svc2:
        for r in reqs:
            svc2.submit("gemm", r).result(WAIT)
    assert sub2.evals == 1        # without brownout: one model evaluation


def test_buckets_are_decided_under_the_model_and_counted():
    rt = AdsalaRuntime()
    default, other = _knobs("trmm")
    sub = FixedSub(other, op="trmm")
    rt.register(sub)
    cfg = cpu_cfg(max_batch=4, linger_ms=60_000.0, min_steal=4, workers=1)
    with BlasService(runtime=rt, config=cfg, device="cpu") as svc:
        for f in [svc.submit("trmm", make("trmm", (24, 8), seed=i))
                  for i in range(8)]:
            f.result(WAIT)
    st = rt.stats
    assert sub.evals == 1 and st.model_evals == 1 and st.default_calls == 0
    assert rt.peek("trmm", (24, 8), 4, backend="hopper") == other
    assert svc.stats.batches == 2 and svc.stats.mean_batch == 4.0
    assert resolve_backend("hopper", device="cpu").device.type == "cpu"
