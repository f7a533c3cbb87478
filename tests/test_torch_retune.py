"""The port's online feedback loop (``repro_torch/serving/retune.py``) on
the CPU: the reference package's retune cases (hot-swap atomicity under
contention, artifact version round-trips through the decision cache, the
drift-detecting Retuner: trigger/no-trigger, telemetry keying, blend
refit, swap wiring, bounded shutdown) with the ``hopper`` backend on
``device="cpu"`` and the reference's drift signal (``anchor_samples=0``);
the port's anchored signal (a standing model error reads no drift, a
change is detected in one step); the service's probes (one bucket a key
and step); and a parity case: the same install dataset and
telemetry fed to both packages' Retuner give the same post-swap
decisions."""

import threading
import time

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.knobs as ref_knobs
import repro.serving.retune as ref_retune
from repro_torch.backends import get_backend
from repro_torch.core import (AdsalaRuntime, ModelRegistry,
                              install_subroutine, knobs)
from repro_torch.core.knobs import Knob
from repro_torch.kernels import ops
from repro_torch.serving import (BlasService, Retuner, RetuneConfig,
                                 ServeConfig, bucket_key)


class GenSub:
    """Stub whose knob carries its generation — a reader can tell WHICH
    model answered its select."""

    def __init__(self, backend: str, gen: int, op: str = "gemm",
                 dtype_bytes: int = 4) -> None:
        self.backend = backend
        self.op = op
        self.dtype_bytes = dtype_bytes
        self.gen = gen
        self.knob = Knob((("gen", gen),))
        self.artifact_version = gen

    def select(self, dims):
        return self.knob


@pytest.fixture(scope="module")
def tuned():
    """One real tuned artifact (flat-time timer keeps the install fast)."""
    space = ops.knob_space_for("gemm", sizes=(64, 128))
    return install_subroutine(
        "gemm", space, lambda dims, knob: 1e-3, n_samples=12,
        dim_lo=32, dim_hi=64, max_footprint_bytes=1_000_000,
        tune_trials=1, candidates=("LinearRegression",), use_lof=False,
        backend="hopper")


# ---------------------------------------------------------------------------
# hot-swap atomicity
# ---------------------------------------------------------------------------

def test_swap_atomicity_under_contention():
    """N threads hammer select/select_many through a stream of swaps.  The
    contract: once swap() has returned, NO select may answer with an older
    generation — a reader that snapshots the published generation before
    its select must get a knob at least that new.  And nothing deadlocks."""
    rt = AdsalaRuntime(cache_size=64)
    rt.register(GenSub("b0", 0))
    dims_pool = [(32 * i, 32, 32) for i in range(1, 5)]
    published = [0]                  # generation of the last COMPLETED swap
    errors = []
    stop = threading.Event()

    def reader(tid):
        try:
            i = 0
            while not stop.is_set():
                i += 1
                g = published[0]
                if i % 3 == 0:
                    knobs = rt.select_many(
                        [("gemm", d, 4, "b0") for d in dims_pool])
                    for k in knobs:
                        assert k["gen"] >= g, (k["gen"], g)
                else:
                    k = rt.select("gemm", dims_pool[i % 4], 4, backend="b0")
                    assert k["gen"] >= g, (k["gen"], g)
        except Exception as e:   # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for gen in range(1, 25):
        rt.swap(GenSub("b0", gen))
        published[0] = gen           # readers starting now must see >= gen
        time.sleep(0.002)
    stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "reader deadlocked across swaps"
    assert not errors, errors[:3]
    s = rt.stats
    assert s.swaps == 24
    # every post-final-swap select answers with the final generation
    assert rt.select("gemm", dims_pool[0], 4, backend="b0")["gen"] == 24


def test_swap_invalidates_only_its_own_subroutine():
    rt = AdsalaRuntime()
    rt.register(GenSub("b0", 1))
    rt.register(GenSub("b1", 1))
    for d in ((32, 32, 32), (64, 32, 32)):
        rt.select("gemm", d, 4, backend="b0")
        rt.select("gemm", d, 4, backend="b1")
    assert rt.swap(GenSub("b0", 2)) == 2
    # b0's decisions are gone, b1's survive untouched
    assert rt.peek("gemm", (32, 32, 32), 4, backend="b0") is None
    assert rt.peek("gemm", (32, 32, 32), 4, backend="b1") is not None
    assert rt.stats.swap_invalidations == 2
    assert rt.select("gemm", (32, 32, 32), 4, backend="b0")["gen"] == 2


def test_register_replacement_also_bumps_epoch():
    """Replacing via register() must not leave stale in-flight or cached
    decisions either (swap() is register-replace + invalidate)."""
    rt = AdsalaRuntime()
    rt.register(GenSub("b0", 1))
    rt.select("gemm", (32, 32, 32), 4, backend="b0")
    rt.register(GenSub("b0", 2))
    # register() does not invalidate the cache (that's swap's contract) —
    # but a cold key must be answered by the new model
    assert rt.select("gemm", (64, 32, 32), 4, backend="b0")["gen"] == 2


# ---------------------------------------------------------------------------
# artifact versioning through the decision cache
# ---------------------------------------------------------------------------

def test_version_bumped_registry_rejects_pre_bump_cache(tmp_path, tuned):
    reg = ModelRegistry(tmp_path)
    reg.save(tuned)                                  # artifact_version 1
    assert tuned.artifact_version == 1
    rt = AdsalaRuntime()
    rt.register(tuned)
    shapes = [(32 * i, 32, 32) for i in range(1, 5)]
    for d in shapes:
        rt.select("gemm", d, 4, backend="hopper")
    reg.save_decision_cache(rt)                      # entries stamped v1

    reg.save(tuned)                                  # bump → 2
    assert tuned.artifact_version == 2
    rt2 = AdsalaRuntime()
    rt2.register(reg.load_all(backend="hopper")[0])  # loads the v2 artifact
    assert reg.load_decision_cache(rt2) == 0         # v1 cache: rejected
    assert rt2.stats.import_drops_version == len(shapes)
    assert rt2.cache_len() == 0

    # the matching-version cache round-trips
    for d in shapes:
        rt2.select("gemm", d, 4, backend="hopper")
    reg.save_decision_cache(rt2)
    rt3 = AdsalaRuntime()
    rt3.register(reg.load_all(backend="hopper")[0])
    assert reg.load_decision_cache(rt3) == len(shapes)
    assert rt3.stats.import_drops_version == 0
    for d in shapes:
        rt3.select("gemm", d, 4, backend="hopper")
    assert rt3.stats.model_evals == 0                # pure warm start


def test_artifact_version_survives_delete_and_reinstall(tmp_path, tuned):
    """versions.json is the authority: deleting the artifact file must not
    reset the counter (a re-install after cleanup must still invalidate
    caches stamped by the deleted generation)."""
    reg = ModelRegistry(tmp_path)
    reg.save(tuned)
    v = tuned.artifact_version
    from repro_torch.core.registry import artifact_name
    (tmp_path / artifact_name(tuned)).unlink()
    reg.save(tuned)
    assert tuned.artifact_version == v + 1


def test_unstamped_artifacts_keep_legacy_cache_semantics(tmp_path):
    """Subroutines never saved through a registry (version 0) interop with
    caches that carry no version — nothing is dropped."""
    rt = AdsalaRuntime()
    rt.register(GenSub("b0", 0))
    rt.select("gemm", (32, 32, 32), 4, backend="b0")
    entries = rt.export_cache()
    assert entries[0]["artifact_version"] == 0
    warm = AdsalaRuntime()
    warm.register(GenSub("b0", 0))
    assert warm.import_cache(entries) == 1
    assert warm.stats.import_drops_version == 0


# ---------------------------------------------------------------------------
# the Retuner
# ---------------------------------------------------------------------------

def drive(rt, ret, dims_pool, measured_fn, *, backend="hopper", items=2):
    """Serve + report one telemetry tick for every pool bucket."""
    for d in dims_pool:
        k = rt.select("gemm", d, 4, backend=backend)
        rt.record_batch("gemm", d, 4, backend, 1,
                        exec_seconds=measured_fn(d, k) * items,
                        exec_items=items)
    return ret.observe()


def test_retuner_no_false_trigger(tuned):
    rt = AdsalaRuntime()
    rt.register(tuned)
    ret = Retuner(rt, config=RetuneConfig(min_samples=2, anchor_samples=0))
    cp = rt.predictor("gemm", 4, backend="hopper")
    pool = [(32, 32, 32), (64, 32, 64), (48, 64, 32)]
    space = tuned.knob_space
    added = drive(rt, ret, pool,
                  lambda d, k: float(cp.predict_times(d)[space.index(k)]))
    assert added == len(pool)
    assert ret.step() == []
    ewma, n = ret.drift("gemm", 4, "hopper")
    assert n == len(pool) and ewma == pytest.approx(0.0, abs=1e-12)
    assert ret.stats.retunes == 0 and ret.stats.drift_events == 0


def test_retuner_detects_drift_and_swaps_without_registry(tuned):
    rt = AdsalaRuntime()
    rt.register(tuned)
    ret = Retuner(rt, config=RetuneConfig(min_samples=3, drift_threshold=0.5,
                                          tune_trials=1, anchor_samples=0))
    cp = rt.predictor("gemm", 4, backend="hopper")
    space = tuned.knob_space
    pool = [(32, 32, 32), (64, 32, 64), (48, 64, 32), (64, 64, 64)]
    drive(rt, ret, pool,
          lambda d, k: 3.0 * float(cp.predict_times(d)[space.index(k)]))
    ewma, _ = ret.drift("gemm", 4, "hopper")
    assert ewma == pytest.approx(2.0, rel=1e-6)      # |3p - p| / p
    swapped = ret.step()
    assert swapped == [("hopper", "gemm", 4)]
    new_sub = rt.subroutine("gemm", 4, backend="hopper")
    assert new_sub is not tuned
    # no registry → local monotonic bump off the old artifact's version
    assert new_sub.artifact_version == tuned.artifact_version + 1
    assert rt.stats.swaps == 1
    assert ret.stats.retunes == 1 and ret.stats.errors == 0
    # state reset: the new model starts with a clean drift signal
    assert ret.drift("gemm", 4, "hopper") == (None, 0)


def test_retuner_telemetry_is_keyed_and_capped(tuned):
    """Re-measuring a bucket REPLACES its sample (stale pre-drift telemetry
    must not feed the refit) and the ring is bounded."""
    rt = AdsalaRuntime()
    rt.register(tuned)
    ret = Retuner(rt, config=RetuneConfig(telemetry_cap=3, min_samples=1,
                                          drift_threshold=1e9,
                                          anchor_samples=0))
    pool = [(32 * i, 32, 32) for i in range(1, 6)]       # 5 buckets, cap 3
    drive(rt, ret, pool, lambda d, k: 1e-3)
    st = ret._state[("hopper", "gemm", 4)]
    assert len(st.samples) == 3                          # capped
    # re-measure the newest bucket with a new value: replaced, not appended
    d = pool[-1]
    k = rt.select("gemm", d, 4, backend="hopper")
    rt.record_batch("gemm", d, 4, "hopper", 1,
                    exec_seconds=4e-3, exec_items=2)
    ret.observe()
    assert len(st.samples) == 3
    idx = tuned.knob_space.index(k)
    assert st.samples[(d, idx)] == pytest.approx(2e-3)   # the NEW value


def test_retuner_retune_without_telemetry_raises(tuned):
    rt = AdsalaRuntime()
    rt.register(tuned)
    ret = Retuner(rt)
    with pytest.raises(RuntimeError, match="no telemetry"):
        ret.retune(("hopper", "gemm", 4))


def test_retuner_refit_follows_measured_surface(tuned, tmp_path):
    """After a drift that flips the cost ordering, the refit model's
    decisions must move off the drifted knob, and the swap must be
    bit-identical to a fresh process loading the saved artifact."""
    reg = ModelRegistry(tmp_path)
    reg.save(tuned)
    v_installed = tuned.artifact_version
    rt = AdsalaRuntime()
    rt.register(tuned)
    ret = Retuner(rt, registry=reg,
                  config=RetuneConfig(min_samples=3, drift_threshold=0.5,
                                      tune_trials=1, anchor_samples=0))
    cp = rt.predictor("gemm", 4, backend="hopper")
    space = tuned.knob_space
    pool = [(32, 32, 32), (64, 32, 64), (48, 64, 32), (64, 64, 64)]
    drive(rt, ret, pool,
          lambda d, k: 4.0 * float(cp.predict_times(d)[space.index(k)]))
    assert ret.step() == [("hopper", "gemm", 4)]
    new_sub = rt.subroutine("gemm", 4, backend="hopper")
    assert new_sub.artifact_version == v_installed + 1

    fresh = AdsalaRuntime()
    fresh.register(reg.load_all(backend="hopper")[0])
    live_cp = rt.predictor("gemm", 4, backend="hopper")
    fresh_cp = fresh.predictor("gemm", 4, backend="hopper")
    for d in pool:
        assert np.array_equal(live_cp.predict_times(d),
                              fresh_cp.predict_times(d))
        assert rt.select("gemm", d, 4, backend="hopper") == \
            fresh.select("gemm", d, 4, backend="hopper")


def test_anchored_signal_ignores_a_standing_model_error(tuned):
    """The default signal: a model that misses every served point by the
    same factor (a linear family is 5x off a (512, 512, 512) GEMM on the
    card) reads no drift, round after round, and the anchors report the
    factor."""
    rt = AdsalaRuntime()
    rt.register(tuned)
    ret = Retuner(rt, config=RetuneConfig(min_samples=3))
    assert ret.config.anchor_samples == 3
    cp = rt.predictor("gemm", 4, backend="hopper")
    space = tuned.knob_space
    pool = [(32, 32, 32), (64, 32, 64), (48, 64, 32)]
    for _ in range(12):
        drive(rt, ret, pool,
              lambda d, k: 5.0 * float(cp.predict_times(d)[space.index(k)]))
        assert ret.step() == []
    ewma, n = ret.drift("gemm", 4, "hopper")
    # the first two samples of each point formed its anchor
    assert n == len(pool) * 10 and ewma == pytest.approx(0.0, abs=1e-12)
    anchors = ret.anchors("gemm", 4, "hopper")
    assert len(anchors) == len(pool)
    assert all(v == pytest.approx(5.0) for v in anchors.values())
    assert ret.stats.drift_events == 0 and ret.stats.samples == 36


def test_anchored_signal_detects_a_change_in_one_step(tuned):
    """Once anchored, the served knob's time x 4 is detected, refit and
    swapped in one step, and the new model starts with fresh anchors."""
    rt = AdsalaRuntime()
    rt.register(tuned)
    ret = Retuner(rt, config=RetuneConfig(min_samples=3, tune_trials=1))
    cp = rt.predictor("gemm", 4, backend="hopper")
    space = tuned.knob_space
    pool = [(32, 32, 32), (64, 32, 64), (48, 64, 32)]
    for _ in range(3):
        drive(rt, ret, pool,
              lambda d, k: 2.0 * float(cp.predict_times(d)[space.index(k)]))
        assert ret.step() == []
    drive(rt, ret, pool,
          lambda d, k: 8.0 * float(cp.predict_times(d)[space.index(k)]))
    assert ret.drift("gemm", 4, "hopper")[0] > ret.config.drift_threshold
    assert ret.step() == [("hopper", "gemm", 4)]
    assert ret.stats.drift_events == 1 and rt.stats.swaps == 1
    assert ret.anchors("gemm", 4, "hopper") == {}


def test_card_lock_gives_a_probe_the_card_alone():
    """Buckets share the card; a probe waits for the running ones, holds
    the card alone, and no bucket starts while it waits or runs."""
    from repro_torch.serving.service import _CardLock
    lock = _CardLock()
    log, gate = [], threading.Event()

    def bucket(name, hold):
        with lock.shared():
            log.append(("start", name))
            hold.wait(5)
            log.append(("end", name))

    first = threading.Event()
    t1 = threading.Thread(target=bucket, args=("a", first))
    t1.start()
    while ("start", "a") not in log:
        time.sleep(0.001)

    def probe():
        with lock.exclusive():
            log.append(("start", "probe"))
            gate.wait(5)
            log.append(("end", "probe"))

    tp = threading.Thread(target=probe)
    tp.start()
    while not lock._waiting:
        time.sleep(0.001)
    late = threading.Event()
    late.set()
    t2 = threading.Thread(target=bucket, args=("b", late))
    t2.start()
    time.sleep(0.05)
    assert ("start", "b") not in log and ("start", "probe") not in log
    first.set()
    t1.join(5)
    while ("start", "probe") not in log:
        time.sleep(0.001)
    assert ("start", "b") not in log
    gate.set()
    for t in (tp, t2):
        t.join(5)
    assert log.index(("end", "a")) < log.index(("start", "probe")) \
        < log.index(("end", "probe")) < log.index(("start", "b"))


def test_service_probes_one_bucket_per_key_and_step(tuned):
    """With a retuner attached the service probes one bucket of a key per
    step: that bucket books one item (its first, run alone), the others
    book none, and every result is the stacked run_op's."""
    rt = AdsalaRuntime()
    rt.register(tuned)
    ret = Retuner(rt, config=RetuneConfig(interval_s=3600.0))
    cfg = ServeConfig(backend="hopper", max_batch=4, linger_ms=1.0)
    gen = torch.Generator().manual_seed(4)
    work = [(torch.randn(48, 32, generator=gen),
             torch.randn(32, 40, generator=gen)) for _ in range(12)]
    with BlasService(runtime=rt, config=cfg, retuner=ret,
                     device="cpu") as svc:
        outs = [f.result(timeout=60)
                for f in [svc.submit("gemm", xs) for xs in work]]
        assert svc.drain(timeout=30)
        key = next(iter(rt.stats.buckets))
        b = rt.stats.buckets[key]
        assert b.requests == 12 and b.exec_items == 1 and b.exec_seconds > 0
        assert not ret.claim_probe(key)        # claimed until the step
        assert ret.observe() == 1
        for f in [svc.submit("gemm", xs) for xs in work[:4]]:
            f.result(timeout=60)
        assert svc.drain(timeout=30)
        assert rt.stats.buckets[key].exec_items == 2
    for (a, w), got in zip(work, outs):
        want = ops.run_op("gemm", (a, w), runtime=rt, device="cpu")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_probe_books_the_median_of_its_timed_calls(tuned):
    """A probe runs the bucket's first item once to warm up, then
    ``PROBE_REPEATS`` timed calls, and books their median, as the install's
    timer takes its labels: one call held up on the host moves nothing."""
    from repro_torch.serving import service as service_mod
    assert service_mod.PROBE_REPEATS == 3
    rt = AdsalaRuntime()
    rt.register(tuned)
    ret = Retuner(rt, config=RetuneConfig(interval_s=3600.0))
    cfg = ServeConfig(backend="hopper", max_batch=4, linger_ms=1.0)
    stacked = (torch.arange(12.0).reshape(3, 4),)
    calls = []

    def call(operands):
        calls.append(operands[0].shape)
        if len(calls) == 3:               # the second timed call
            time.sleep(0.3)
        return operands[0] * 2.0

    with BlasService(runtime=rt, config=cfg, retuner=ret,
                     device="cpu") as svc:
        out, seconds = svc._probe(call, stacked, False)
    assert calls == [(4,)] * (1 + service_mod.PROBE_REPEATS) + [(2, 4)]
    assert torch.equal(out, stacked[0] * 2.0)
    assert 0.0 < seconds() < 0.1


def test_retuner_background_thread_start_stop(tuned):
    rt = AdsalaRuntime()
    rt.register(tuned)
    ret = Retuner(rt, config=RetuneConfig(min_samples=2, drift_threshold=0.5,
                                          interval_s=0.02, tune_trials=1,
                                          anchor_samples=0))
    cp = rt.predictor("gemm", 4, backend="hopper")
    space = tuned.knob_space
    pool = [(32, 32, 32), (64, 32, 64), (48, 64, 32)]
    for d in pool:
        k = rt.select("gemm", d, 4, backend="hopper")
        rt.record_batch("gemm", d, 4, "hopper", 1,
                        exec_seconds=3.0 * float(
                            cp.predict_times(d)[space.index(k)]) * 2,
                        exec_items=2)
    ret.start()
    ret.start()                                      # idempotent
    deadline = time.monotonic() + 30
    while ret.stats.retunes == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    ret.stop()
    ret.stop()                                       # idempotent
    assert ret.stats.retunes >= 1 and ret.stats.errors == 0
    assert rt.stats.swaps >= 1


# ---------------------------------------------------------------------------
# serving integration: queue/exec split + service-managed retuner
# ---------------------------------------------------------------------------

def test_serving_splits_queue_and_exec_time():
    rt = AdsalaRuntime()
    cfg = ServeConfig(backend="hopper", max_batch=8, linger_ms=2.0)
    dims = (48, 32, 40)
    operands = get_backend("hopper").on("cpu").make_operands(
        "gemm", dims, torch.float32, seed=0)
    with BlasService(runtime=rt, config=cfg, device="cpu") as svc:
        futs = [svc.submit("gemm", operands) for _ in range(12)]
        for f in futs:
            f.result(timeout=30)
        stats = svc.stats
    assert stats.exec_sum > 0.0 and stats.queue_sum > 0.0
    assert stats.mean_exec_latency > 0.0 and stats.mean_queue_latency > 0.0
    key = bucket_key("gemm", [a.shape for a in operands],
                     [a.dtype for a in operands], "hopper")
    backend, op, dtype_bytes, dims_key = key[0], key[1], key[2], key[3]
    b = rt.stats.buckets[(backend, op, dtype_bytes, dims_key)]
    assert b.exec_items == 12
    assert b.exec_seconds > 0.0
    assert b.mean_exec_per_item == pytest.approx(
        b.exec_seconds / b.exec_items)
    # queue time is tracked separately — it must NOT inflate exec time
    assert b.queue_seconds >= 0.0
    assert b.mean_queue >= 0.0


def test_service_starts_and_stops_retuner(tuned):
    rt = AdsalaRuntime()
    rt.register(tuned)
    ret = Retuner(rt, config=RetuneConfig(interval_s=0.05))
    cfg = ServeConfig(backend="hopper", max_batch=4, linger_ms=2.0)
    with BlasService(runtime=rt, config=cfg, retuner=ret,
                     device="cpu") as svc:
        assert svc.retuner is ret
        assert ret._thread is not None and ret._thread.is_alive()
    assert ret._thread is None or not ret._thread.is_alive()


# ---------------------------------------------------------------------------
# bounded shutdown: stop() join budget + abandoned-refit accounting
# ---------------------------------------------------------------------------

def test_retuner_stop_abandons_stuck_thread_without_leaking():
    rt = AdsalaRuntime()
    ret = Retuner(rt, config=RetuneConfig(interval_s=60.0))
    release = threading.Event()
    stuck = threading.Thread(target=release.wait, daemon=True)
    stuck.start()
    ret._thread = stuck                 # simulate a thread wedged mid-refit
    t0 = time.monotonic()
    assert ret.stop(timeout=0.2) is False
    assert time.monotonic() - t0 < 2.0  # the join was bounded, not 10 s
    assert ret.stats.abandoned_stops == 1
    # the thread reference is KEPT — abandoned, counted, not leaked
    assert ret._thread is stuck
    release.set()
    assert ret.stop(timeout=5.0) is True
    assert ret._thread is None
    assert ret.stats.abandoned_stops == 1


def test_retuner_stop_counts_each_abandonment():
    rt = AdsalaRuntime()
    ret = Retuner(rt, config=RetuneConfig(interval_s=60.0))
    release = threading.Event()
    stuck = threading.Thread(target=release.wait, daemon=True)
    stuck.start()
    ret._thread = stuck
    assert ret.stop(timeout=0.05) is False
    assert ret.stop(timeout=0.05) is False
    assert ret.stats.abandoned_stops == 2
    release.set()
    stuck.join(timeout=5.0)


class _RecordingRetuner:
    """start()/stop() shim standing in for a Retuner whose refit outlasts
    the service's close budget."""

    def __init__(self, stop_result=True):
        self.stop_result = stop_result
        self.stop_timeouts = []
        self.starts = 0

    def start(self):
        self.starts += 1

    def stop(self, timeout=10.0):
        self.stop_timeouts.append(timeout)
        return self.stop_result


def test_service_close_bounds_retuner_join_by_remaining_budget():
    rt = AdsalaRuntime()
    shim = _RecordingRetuner(stop_result=True)
    svc = BlasService(runtime=rt,
                      config=ServeConfig(backend="hopper", workers=1),
                      retuner=shim, device="cpu")
    svc.close(timeout=4.0)
    assert shim.starts == 1
    assert len(shim.stop_timeouts) == 1
    # the join got what was LEFT of the close budget, not a fixed default:
    # bounded above by the caller's timeout, floored at the 0.1 s minimum
    assert 0.1 <= shim.stop_timeouts[0] <= 4.0
    assert svc.stats.retuner_abandoned == 0


def test_service_close_counts_abandoned_retuner():
    rt = AdsalaRuntime()
    shim = _RecordingRetuner(stop_result=False)
    svc = BlasService(runtime=rt,
                      config=ServeConfig(backend="hopper", workers=1),
                      retuner=shim, device="cpu")
    svc.close(timeout=2.0)
    assert svc.stats.retuner_abandoned == 1
    # close() stays idempotent; the second call must not re-join the retuner
    svc.close(timeout=2.0)
    assert len(shim.stop_timeouts) == 1


# ---------------------------------------------------------------------------
# parity with the reference package's Retuner
# ---------------------------------------------------------------------------

#: the reference's retune_bench surface: (bm, bn) weights, monotone in the
#: grid parallelism, and the drift that makes the pre-drift optimum 4x
#: slower (the surface turns non-monotone)
WEIGHTS = {(64, 64): 1.0, (64, 32): 2.0, (32, 64): 2.5, (32, 32): 3.0}
POOL = [(96, 64, 160), (192, 96, 64), (64, 32, 128),
        (160, 64, 96), (128, 160, 64), (224, 32, 96)]


def _cost(dims, knob, *, drifted=False):
    m, k, n = dims
    w = WEIGHTS[(knob["bm"], knob["bn"])]
    if drifted and (knob["bm"], knob["bn"]) == (64, 64):
        w *= 4.0
    return 1e-4 * (m * k * n) / (64 ** 3) * w


def test_retuner_parity_with_reference():
    """The same install dataset (one knob space, one seeded sweep) and the
    same drifted telemetry, fed to both packages' Retuner with the model
    family fixed to DecisionTree (selection between families flips on
    timer noise), give the same drift reading, the same refit's
    predictions and the same decisions after the swap."""
    cands = dict(bms=(32, 64), bks=(32,), bns=(32, 64))
    subs = {}
    for name, core_mod, kmod in (("port", None, knobs),
                                 ("ref", ref_core, ref_knobs)):
        space = kmod.block_knob_space(**cands)
        install = install_subroutine if core_mod is None \
            else core_mod.install_subroutine
        subs[name] = install(
            "gemm", space, lambda dims, knob: _cost(dims, knob),
            n_samples=24, dim_lo=32, dim_hi=256, max_footprint_bytes=None,
            tune_trials=1, candidates=("DecisionTree",), use_lof=False,
            seed=0, backend="hopper")
    np.testing.assert_array_equal(subs["port"].dataset.times,
                                  subs["ref"].dataset.times)
    out = {}
    for name, rt_cls, ret_cls, cfg_cls in (
            ("port", AdsalaRuntime, Retuner, RetuneConfig),
            ("ref", ref_core.AdsalaRuntime, ref_retune.Retuner,
             ref_retune.RetuneConfig)):
        rt = rt_cls()
        rt.register(subs[name])
        # the port with the reference's signal (no anchor)
        anchor = {"anchor_samples": 0} if name == "port" else {}
        ret = ret_cls(rt, config=cfg_cls(
            min_samples=len(POOL), drift_threshold=0.5, telemetry_repeat=4,
            tune_trials=1, seed=0, candidates=("DecisionTree",), **anchor))
        before = [rt.select("gemm", d, 4, backend="hopper") for d in POOL]
        for d, k in zip(POOL, before):
            rt.record_batch("gemm", d, 4, "hopper", 1,
                            exec_seconds=2 * _cost(d, k, drifted=True),
                            exec_items=2)
        ret.observe()
        ewma, n = ret.drift("gemm", 4, "hopper")
        assert ret.step() == [("hopper", "gemm", 4)]
        cp = rt.predictor("gemm", 4, backend="hopper")
        probe = POOL + [(64, 64, 64), (256, 256, 256), (40, 200, 120)]
        out[name] = (ewma, n, [tuple(before[i].values) for i in range(len(POOL))],
                     [tuple(rt.select("gemm", d, 4, backend="hopper").values)
                      for d in probe],
                     np.stack([cp.predict_times(d) for d in probe]))
    assert out["port"][:4] == out["ref"][:4]
    np.testing.assert_allclose(out["port"][4], out["ref"][4], rtol=1e-12)
    # the drift moved the decisions off the drifted (64, 64) tile
    assert any(dict(k)["bm"] != 64 or dict(k)["bn"] != 64
               for k in out["port"][3][:len(POOL)])
