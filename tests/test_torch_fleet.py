"""The port's multi-process fleet (``repro_torch/serving/fleet.py``), its
membership (``repro_torch/distributed/elastic.py``) and the fingerprint
that names the card (``repro_torch/core/registry.py``), on the CPU.

Executors are spawned processes running the kernels' plain versions
(``device="cpu"``), at most two a test: results against the in-process
``run_op`` bit for bit, a warm join with zero model evals, a respawn after
a SIGKILL with no future lost, an executor whose device is absent failing
to start, the front end's telemetry booked as the in-process service books
it without a retuner.  The fingerprint
cases: an artifact calibrated on one card is never resolved for a host
with another card or with none, and a host without a card resolves as the
reference package does."""

import json
import os
import signal
import time

import numpy as np
import pytest
import torch

import repro.core.registry as ref_registry
from repro_torch.core import ModelRegistry, install_subroutine
from repro_torch.core.registry import (fingerprint_distance, fingerprint_slug,
                                       gpu_key, host_fingerprint)
from repro_torch.distributed import FleetMembership
from repro_torch.kernels import ops
from repro_torch.serving import (ExecutorDiedError, FleetConfig,
                                 FleetService, ServeConfig,
                                 ServiceClosedError)

H100 = {"name": "NVIDIA H100 80GB HBM3", "capability": "9.0", "sms": 132,
        "memory_mb": 81559}
A100 = {"name": "NVIDIA A100-SXM4-80GB", "capability": "8.0", "sms": 108,
        "memory_mb": 81038}
HOST = {"cpu_model": "EPYC 7B13", "machine": "x86_64", "cores": 16,
        "cache_line": 64}


def _cpu_fleet(processes: int, **kw) -> FleetService:
    return FleetService(
        fleet=FleetConfig(processes=processes, membership=False, **kw),
        config=ServeConfig(max_batch=4, linger_ms=1.0), device="cpu")


def _gemm(rng, m, k, n):
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

def test_host_fingerprint_names_the_card_or_none():
    fp = host_fingerprint()
    assert set(fp) == {"cpu_model", "machine", "cores", "cache_line", "gpu"}
    json.dumps(fp)
    if torch.cuda.is_available():
        assert fp["gpu"]["name"] == torch.cuda.get_device_name(0)
        assert gpu_key(fp) and fingerprint_slug(fp).count("-g") == 1
    else:
        assert fp["gpu"] == {} and gpu_key(fp) == ""
    # a fingerprint without a card keeps the reference package's slug
    cpu_only = {k: v for k, v in fp.items() if k != "gpu"}
    assert fingerprint_slug(fp if not fp["gpu"] else cpu_only) == \
        ref_registry.fingerprint_slug(cpu_only)


def test_gpu_distance_is_infinite_across_cards():
    h = dict(HOST, gpu=H100)
    assert fingerprint_distance(h, dict(HOST, gpu=A100)) == float("inf")
    assert fingerprint_distance(h, dict(HOST, gpu={})) == float("inf")
    assert fingerprint_distance(h, HOST) == float("inf")   # legacy: no card
    assert fingerprint_distance(h, dict(h, cores=32)) == pytest.approx(1.0)
    assert fingerprint_slug(h) != fingerprint_slug(dict(HOST, gpu=A100)) \
        != fingerprint_slug(HOST)


def test_card_tagged_artifacts_never_resolve_for_another_card_or_none(
        tmp_path):
    reg = ModelRegistry(tmp_path)
    h100 = reg.for_fingerprint(dict(HOST, gpu=H100), create=True)
    a100 = reg.for_fingerprint(dict(HOST, gpu=A100), create=True)
    # another card: the flat root, never the nearest of another card
    other = dict(HOST, gpu=dict(H100, name="NVIDIA L4", sms=58))
    assert reg.resolve_fingerprint(other).root == reg.root
    assert reg.last_fingerprint_resolution["mode"] == "flat"
    assert reg.last_fingerprint_resolution["skipped"] == 2
    # no card, the same CPU: the flat root too
    assert reg.resolve_fingerprint(dict(HOST, gpu={})).root == reg.root
    # the same card on another host: the nearest of that card only
    got = reg.resolve_fingerprint(dict(HOST, cores=64, gpu=H100))
    assert got.root == h100.root
    res = reg.last_fingerprint_resolution
    assert res["mode"] == "nearest" and res["distance"] == pytest.approx(2.0)
    assert reg.resolve_fingerprint(dict(HOST, gpu=A100)).root == a100.root
    assert reg.last_fingerprint_resolution["mode"] == "exact"


@pytest.mark.parametrize("query", [
    HOST, dict(HOST, cores=32), {"cpu_model": "Graviton3",
                                 "machine": "aarch64", "cores": 64,
                                 "cache_line": 64}])
def test_cpu_only_resolution_matches_the_reference(tmp_path, query):
    layouts = {}
    stranger = {"cpu_model": "Graviton3", "machine": "aarch64", "cores": 64,
                "cache_line": 64}
    for name, mod in (("port", None), ("ref", ref_registry)):
        root = tmp_path / name
        reg = ModelRegistry(root) if mod is None else mod.ModelRegistry(root)
        want_flat = reg.resolve_fingerprint(query)
        flat = (want_flat.root == reg.root,
                dict(reg.last_fingerprint_resolution))
        reg.for_fingerprint(HOST, create=True)
        reg.for_fingerprint(stranger, create=True)
        got = reg.resolve_fingerprint(query)
        res = dict(reg.last_fingerprint_resolution)
        layouts[name] = (flat[0], flat[1]["mode"], got.root.name,
                         res["mode"], res["slug"], res["distance"])
    assert layouts["port"] == layouts["ref"]


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------

def test_fleet_membership_goes_stale_after_a_missed_heartbeat(tmp_path):
    m = FleetMembership(tmp_path / "members", stale_s=0.3)
    m.register("exec-1", slug="x86")
    m.register("exec-2")
    assert {r["name"] for r in m.members()} == {"exec-1", "exec-2"}
    assert all(r["pid"] == os.getpid() for r in m.members())
    time.sleep(0.35)
    m.heartbeat("exec-1")                           # exec-2 missed its beat
    assert {r["name"] for r in m.members()} == {"exec-1"}
    assert {r["name"] for r in m.members(live_only=False)} == \
        {"exec-1", "exec-2"}
    (tmp_path / "members" / "torn.json").write_text("{not json")
    assert {r["name"] for r in m.members()} == {"exec-1"}
    m.deregister("exec-1")
    m.deregister("exec-1")                          # idempotent
    assert m.members() == []


# ---------------------------------------------------------------------------
# the fleet (spawned CPU executors)
# ---------------------------------------------------------------------------

def test_fleet_results_equal_in_process_run_op():
    rng = np.random.default_rng(7)
    svc = _cpu_fleet(2)
    try:
        work = []
        for op, shapes in (("gemm", ((48, 32), (32, 24))),
                           ("trmm", ((40, 40), (40, 24)))) * 4:
            xs = tuple(rng.standard_normal(s).astype(np.float32)
                       for s in shapes)
            work.append((op, xs, svc.submit(op, xs)))
        for op, xs, fut in work:
            got = fut.result(timeout=120)
            want = ops.run_op(op, tuple(map(torch.from_numpy, xs)),
                              device="cpu")
            assert got.device.type == "cpu" and torch.equal(got, want)
        assert svc.stats.completed == len(work) and svc.stats.failed == 0
        stats = svc.fleet_stats()
        assert len(stats) == 2 and all(d["alive"] for d in stats)
        assert all(d["device"] == "cpu" for d in stats)
    finally:
        svc.close()
    svc.close()                                     # idempotent
    with pytest.raises(ServiceClosedError):
        svc.submit("gemm", (np.eye(8, dtype=np.float32),) * 2)


def test_fleet_warm_member_joins_with_zero_evals(tmp_path):
    reg = ModelRegistry(tmp_path)
    sub = install_subroutine(
        "gemm", ops.knob_space_for("gemm", sizes=(64, 128)),
        lambda dims, knob: 1e-3 * (1 + knob["bm"] / dims[0]), n_samples=12,
        dim_lo=32, dim_hi=96, max_footprint_bytes=1_000_000, tune_trials=1,
        candidates=("LinearRegression",), use_lof=False, seed=11)
    reg.for_fingerprint(create=True).save(sub)
    rng = np.random.default_rng(3)
    shapes = [(32, 32, 32), (48, 32, 32), (64, 48, 32)]
    svc = FleetService(
        fleet=FleetConfig(processes=1, registry_root=str(tmp_path)),
        config=ServeConfig(max_batch=4, linger_ms=1.0), device="cpu")
    try:
        for f in [svc.submit("gemm", _gemm(rng, *s)) for s in shapes]:
            f.result(timeout=120)
        first = svc.fleet_stats()[0]
        assert first["loaded"] == 1 and first["model_evals"] >= 1
        assert first["resolution"]["mode"] == "exact"
        info = svc.add_member()                    # the warm join
        assert info["warm_started"] >= len(shapes)
        for f in [svc.submit("gemm", _gemm(rng, *s)) for s in shapes * 4]:
            f.result(timeout=120)
        stats = svc.fleet_stats()
        joined = next(d for d in stats if d["member"] == info["member"])
        assert len(stats) == 2 and joined["model_evals"] == 0
        # the live members registered themselves
        names = {r["name"] for r in FleetMembership(
            tmp_path / "members").members()}
        assert info["member"] in names
    finally:
        svc.close()


def test_fleet_executor_respawns_after_a_kill():
    svc = _cpu_fleet(1, request_timeout_s=60.0)
    try:
        a = np.eye(16, dtype=np.float32)
        pid = svc._executors[0].proc.pid
        os.kill(pid, signal.SIGKILL)
        svc._executors[0].proc.join(timeout=10)
        fut = svc.submit("gemm", (a, a))
        assert torch.equal(fut.result(timeout=120), torch.from_numpy(a))
        assert svc.stats.worker_respawns >= 1
        assert svc.stats.completed == 1 and svc.stats.failed == 0
        assert svc.fleet_stats()[0]["pid"] != pid
    finally:
        svc.close()


def test_fleet_books_what_the_service_books_without_a_retuner():
    """The same traffic through a fleet and through the in-process service
    (no retuner: the fleet takes none) books every bucket's execution over
    all its items, in both."""
    from repro_torch.core import AdsalaRuntime
    from repro_torch.serving import BlasService
    rng = np.random.default_rng(5)
    work = [_gemm(rng, 32, 24, 16) for _ in range(6)] + \
        [_gemm(rng, 40, 32, 8) for _ in range(5)]
    books = {}
    cfg = ServeConfig(max_batch=4, linger_ms=1.0)
    front, rt = AdsalaRuntime(), AdsalaRuntime()
    fleet = FleetService(fleet=FleetConfig(processes=1, membership=False),
                         config=cfg, runtime=front, device="cpu")
    svc = BlasService(runtime=rt, config=cfg, device="cpu")
    try:
        for name, service, runtime in (("fleet", fleet, front),
                                       ("service", svc, rt)):
            for f in [service.submit("gemm", xs) for xs in work]:
                f.result(timeout=120)
            assert service.drain(timeout=60)
            books[name] = {k[3]: (b.requests, b.exec_items)
                           for k, b in runtime.stats.buckets.items()}
            assert all(b.exec_seconds > 0
                       for b in runtime.stats.buckets.values())
            assert service.stats.exec_sum > 0
    finally:
        fleet.close()
        svc.close()
    assert books["fleet"] == books["service"]
    assert sorted(books["fleet"].values()) == [(5, 5), (6, 6)]


def test_fleet_executors_run_on_their_device_or_fail():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: its executors would start")
    # the default device is the card: without one the executor does not
    # start (no executor serves on another device)
    with pytest.raises(ExecutorDiedError, match="does not have"):
        FleetService(fleet=FleetConfig(processes=1, membership=False))
