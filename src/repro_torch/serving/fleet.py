"""Multi-process serving fleet: sharded executors behind one front-end (the
reference package's ``serving/fleet.py`` on the port's runtime and kernels).

The in-process :class:`~repro_torch.serving.service.BlasService` is
GIL-bound: every stacked execution shares one interpreter.
:class:`FleetService` keeps the service's entire front half —
``submit``→Future, shape bucketing, admission control, deadlines,
backpressure, linger/steal scheduling — and replaces only the execution
transport: a flushed bucket is shipped over a duplex pipe to one of N
single-threaded **executor processes**, each owning its own
:class:`~repro_torch.core.runtime.AdsalaRuntime`, backend and CUDA
context, and the stacked result rides back as a pickled host array.

::

    submit() ─▶ buckets ─▶ ready queue ─▶ dispatcher thread i ═══ pipe ═══▶ executor process i
                 (front-end: one process)                             (runtime + backend + CUDA context)
                                                  ▲                        │
                                                  └── shared decision journal ◀┘  (flock appends,
                                                      mtime/offset polls)          every process)

On the card:

* **process start** — an executor is always started with ``spawn``: a
  forked child of a process that has initialised CUDA cannot use the card;
* **payloads** — host arrays pickled over the pipe, as in the reference:
  the executor copies a bucket's columns to its device, runs one stacked
  ``run_op`` there and sends back a host array (CUDA IPC is a later
  design choice);
* **execution time** — ``exec_s`` is the span of CUDA events around the
  executor's stacked ``run_op`` on its stream, and the front end books it
  over the bucket's items: what the in-process service books without a
  retuner (the fleet takes none, as in the reference);
* **devices** — an executor resolves its backend on the fleet's ``device``
  (the backend's own, the card, unless the caller names one) before it
  announces itself ready, and fails to start where that device is absent:
  no executor serves on another device.

Fleet-wide decision coherence is file-based: every executor appends its
miss-path decisions and quarantines to the ONE decision journal of the
shared :class:`~repro_torch.core.registry.ModelRegistry` and absorbs its
peers' entries on a cheap size/offset poll between requests.  A warm member
therefore pays **zero model evaluations** for any shape a peer has already
decided.  Each executor resolves the artifact set for its own
**architecture fingerprint** (``ModelRegistry.resolve_fingerprint``: exact
→ nearest of the same card → flat root), so one registry directory serves
a heterogeneous fleet and never hands one card's models to another.

Supervision mirrors the in-process worker respawn machinery: a dead or hung
executor process is killed and respawned by the dispatcher that observed
it, its claimed bucket is requeued, and a bucket that keeps killing
executors is failed after 3 recoveries instead of crash-looping the fleet.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.serving.service import (BlasService, ExecutionFailedError,
                                         ServeConfig, _resolve_exc,
                                         _resolve_result)

__all__ = ["FleetConfig", "FleetService", "ExecutorDiedError"]


class ExecutorDiedError(RuntimeError):
    """An executor process died (or hung past the request timeout) while
    holding a bucket; surfaced to callers only after respawn + requeue has
    been exhausted (as the ``__cause__`` of ExecutionFailedError)."""


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Topology/transport knobs of the multi-process fleet."""
    processes: int = 2            # executor processes (= dispatcher threads)
    registry_root: Optional[str] = None
                                  # shared ModelRegistry directory: artifact
                                  # sets (fingerprint-resolved) + the ONE
                                  # decision journal every member appends to
                                  # and absorbs from.  None = cold isolated
                                  # executors (no cross-process coherence)
    cache_size: int = 256         # each executor runtime's decision LRU
    journal_poll_s: float = 0.05  # executor idle tick: absorb peers'
                                  # journal entries + heartbeat cadence
    start_timeout_s: float = 120.0    # executor ready handshake (includes
                                  # the child's torch import + artifact load)
    request_timeout_s: float = 120.0  # per-bucket round-trip bound; a
                                  # hung executor is killed + respawned
    fingerprint: Optional[dict] = None
                                  # architecture fingerprint override for
                                  # artifact resolution (None = each
                                  # executor probes its own host and card)
    membership: bool = True       # register executors in
                                  # <registry_root>/members/ (no-op
                                  # without a registry_root)

    def __post_init__(self) -> None:
        if self.processes < 1:
            raise ValueError("processes must be >= 1")
        if self.cache_size < 1:
            raise ValueError("cache_size must be >= 1")
        if self.journal_poll_s <= 0:
            raise ValueError("journal_poll_s must be > 0")
        if self.start_timeout_s <= 0:
            raise ValueError("start_timeout_s must be > 0")
        if self.request_timeout_s <= 0:
            raise ValueError("request_timeout_s must be > 0")


# -- executor child ----------------------------------------------------------

def _executor_main(conn, spec: dict) -> None:
    """Executor process body: one runtime, one backend on one device, one
    pipe.

    Protocol (parent → child, all tuples):
      ("exec", seq, op, backend, columns, kw)  → (seq, "ok", out, info)
                                               | (seq, "err", msg, tb)
      ("stats", seq)                           → (seq, "ok", dict)
      ("absorb", seq)                          → (seq, "ok", n_absorbed)
      ("close", seq)                           → (seq, "ok", dict), exit

    The child announces ("ready", info) once its backend is resolved on its
    device, its CUDA context created and its runtime hydrated —
    fingerprint-resolved artifacts loaded, decision cache warm-started from
    the shared snapshot + journal — so the parent's measured window never
    includes the torch import, the context or the model load.  A child whose device is absent announces
    ("failed", message) and exits.
    """
    from repro_torch.backends import resolve_backend
    from repro_torch.core.runtime import AdsalaRuntime
    from repro_torch.kernels.ops import run_op

    device = spec.get("device")
    try:
        be = resolve_backend(spec["backend"], device=device)
    except Exception as e:           # noqa: BLE001 — reported, then exit
        conn.send(("failed", f"{type(e).__name__}: {e}"))
        return
    if be.device.type == "cuda":
        # the CUDA context before the handshake: a request never pays it
        torch.empty(1, device=be.device)
    rt = AdsalaRuntime(cache_size=int(spec.get("cache_size", 256)))
    follower = None
    membership = None
    member = str(spec.get("member", f"executor-{os.getpid()}"))
    info: dict = {"pid": os.getpid(), "member": member, "loaded": 0,
                  "warm_started": 0, "resolution": {},
                  "device": str(be.device),
                  "device_name": (torch.cuda.get_device_name(be.device)
                                  if be.device.type == "cuda" else "cpu")}
    root = spec.get("registry_root")
    if root:
        from repro_torch.core.registry import ModelRegistry, host_fingerprint
        base = ModelRegistry(root)
        fp = spec.get("fingerprint") or host_fingerprint()
        reg = base.resolve_fingerprint(fp)
        info["resolution"] = dict(base.last_fingerprint_resolution)
        info["loaded"] = reg.load_into(rt)
        try:
            info["warm_started"] = reg.load_decision_cache(rt)
        except Exception:        # noqa: BLE001 — cold start, never fatal
            info["warm_started"] = 0
        # journal every NEW decision/quarantine to the shared store, and
        # tail the same file for the peers' entries.  The follower starts
        # at offset 0: its first poll overlaps what load_decision_cache
        # already imported, which is harmless (idempotent) and closes the
        # window where a peer appends between the load and the first poll.
        rt.decision_journal = reg.journal_decision
        follower = reg.journal_follower()
        rt.absorb_journal(follower.poll())
        if spec.get("membership"):
            from repro_torch.distributed.elastic import FleetMembership
            membership = FleetMembership(os.path.join(root, "members"))
            membership.register(member, slug=str(
                info["resolution"].get("slug", "")))

    def absorb() -> int:
        if follower is None or not follower.changed():
            return 0
        return rt.absorb_journal(follower.poll())

    def stats() -> dict:
        s = rt.stats
        return {"pid": os.getpid(), "member": member,
                "model_evals": s.model_evals, "cache_hits": s.cache_hits,
                "calls": s.calls, "default_calls": s.default_calls,
                "journal_absorbed": s.journal_absorbed,
                "quarantines": s.quarantines,
                "cache_len": rt.cache_len(),
                "loaded": info["loaded"],
                "warm_started": info["warm_started"],
                "resolution": info["resolution"],
                "device": info["device"],
                "device_name": info["device_name"]}

    def execute(op, backend, columns, kw):
        """One stacked run_op on the device: the host result and its
        execution span (CUDA events around it on the card)."""
        stacked = tuple(torch.from_numpy(np.stack(col)).to(be.device)
                        for col in columns)
        if be.device.type != "cuda":
            t0 = time.monotonic()
            out = run_op(op, stacked, backend=backend, runtime=rt,
                         device=be.device, **kw)
            return out.numpy(), time.monotonic() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_op(op, stacked, backend=backend, runtime=rt,
                     device=be.device, **kw)
        end.record()
        host = out.cpu().numpy()
        return host, start.elapsed_time(end) / 1e3

    conn.send(("ready", info))
    poll_s = float(spec.get("journal_poll_s", 0.05))
    try:
        while True:
            if not conn.poll(poll_s):
                absorb()                     # idle tick: fleet coherence
                if membership is not None:
                    try:
                        membership.heartbeat(member)
                    except OSError:
                        pass
                continue
            try:
                msg = conn.recv()
            except (EOFError, OSError):      # parent is gone
                return
            kind, seq = msg[0], msg[1]
            if kind == "close":
                conn.send((seq, "ok", stats()))
                return
            if kind == "stats":
                conn.send((seq, "ok", stats()))
                continue
            if kind == "absorb":
                conn.send((seq, "ok", absorb()))
                continue
            if kind != "exec":
                conn.send((seq, "err", f"unknown message {kind!r}", ""))
                continue
            _, _, op, backend, columns, kw = msg
            try:
                # absorb BEFORE selecting: a peer may have decided this
                # very shape — that is the zero-eval fleet warm path
                absorb()
                out, exec_s = execute(op, backend, columns, kw)
                conn.send((seq, "ok", out, {"exec_s": exec_s}))
            except Exception as e:   # noqa: BLE001 — reply, don't die
                conn.send((seq, "err", f"{type(e).__name__}: {e}",
                           traceback.format_exc()))
    except (EOFError, OSError, BrokenPipeError):
        return


# -- parent-side executor handle ---------------------------------------------

class _Executor:
    """Parent handle for one executor process: owns the pipe, enforces the
    strict request/reply protocol (sequence-numbered), and serialises
    callers (the paired dispatcher thread vs. fleet_stats from the main
    thread) with a per-handle lock."""

    def __init__(self, ctx, spec: dict, name: str,
                 start_timeout_s: float) -> None:
        self.name = name
        self.conn, child_conn = ctx.Pipe(duplex=True)
        self.proc = ctx.Process(target=_executor_main,
                                args=(child_conn, spec),
                                name=name, daemon=True)
        self.proc.start()
        child_conn.close()               # child's end lives in the child
        self._lock = threading.Lock()
        self._seq = 0
        self.ready_info: dict = {}
        if not self.conn.poll(start_timeout_s):
            self.kill()
            raise ExecutorDiedError(
                f"{name}: no ready handshake within {start_timeout_s}s")
        tag, payload = self.conn.recv()
        if tag != "ready":
            self.kill()
            raise ExecutorDiedError(f"{name}: did not start: {payload}")
        self.ready_info = payload

    def alive(self) -> bool:
        return self.proc.is_alive()

    def request(self, kind: str, *payload, timeout: float):
        """One round-trip; returns the reply tuple tail (after the seq).
        Raises :class:`ExecutorDiedError` on a dead pipe or a timeout —
        the caller decides whether to respawn."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            try:
                self.conn.send((kind, seq, *payload))
            except (OSError, ValueError, BrokenPipeError) as e:
                raise ExecutorDiedError(f"{self.name}: send failed") from e
            deadline = time.monotonic() + timeout
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ExecutorDiedError(
                        f"{self.name}: no reply within {timeout}s")
                try:
                    if not self.conn.poll(min(remaining, 0.5)):
                        if not self.proc.is_alive():
                            raise ExecutorDiedError(
                                f"{self.name}: process died mid-request")
                        continue
                    reply = self.conn.recv()
                except (EOFError, OSError) as e:
                    raise ExecutorDiedError(
                        f"{self.name}: pipe closed mid-request") from e
                if reply[0] == seq:
                    return reply[1:]
                # stale reply from a timed-out predecessor: drop it

    def stop(self, timeout: float) -> None:
        """Graceful close → join → terminate → kill, in that order."""
        try:
            self.request("close", timeout=timeout)
        except ExecutorDiedError:
            pass
        self.proc.join(timeout=max(0.1, timeout))
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=1.0)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=1.0)
        self.conn.close()

    def kill(self) -> None:
        try:
            self.proc.kill()
            self.proc.join(timeout=1.0)
        except Exception:        # noqa: BLE001 — already gone
            pass
        try:
            self.conn.close()
        except OSError:
            pass


# -- the fleet front-end ------------------------------------------------------

class FleetService(BlasService):
    """:class:`BlasService` front-end over N executor *processes*.

    Same ``submit``/``call``/``drain``/``close`` surface and the same
    bucketing/admission/backpressure semantics; only the execution
    transport differs (see the module docstring).  One dispatcher thread
    is paired 1:1 with each executor process, so ``config.workers`` is
    forced to ``fleet.processes``.  The executors run on ``device`` (None:
    the backend's own, the card); results come back as CPU tensors.

    The front end deliberately holds **no registry**: executors journal
    their own decisions into the shared store, and a parent-side
    ``save_decision_cache`` on close would snapshot the front end's
    (empty) cache and truncate the very journal the fleet's warm state
    lives in.
    """

    def __init__(self, *, fleet: Optional[FleetConfig] = None,
                 config: Optional[ServeConfig] = None,
                 runtime=None, faults=None, device=None) -> None:
        self.fleet = fleet if fleet is not None else FleetConfig()
        cfg = config if config is not None else ServeConfig()
        cfg = dataclasses.replace(cfg, workers=self.fleet.processes)
        self._exec_device = None if device is None else str(device)
        self._executors: list[_Executor] = []
        self._spawned = 0
        self._ctx = mp.get_context("spawn")
        self._backend_name = cfg.backend
        try:
            for _ in range(self.fleet.processes):
                self._executors.append(self._spawn_executor())
        except BaseException:
            for ex in self._executors:
                ex.kill()
            raise
        super().__init__(runtime=runtime, config=cfg, registry=None,
                         retuner=None, faults=faults, device=device)

    # -- executor lifecycle ---------------------------------------------------
    def _spawn_executor(self) -> _Executor:
        f = self.fleet
        self._spawned += 1
        member = f"executor-{os.getpid()}-{self._spawned}"
        spec = {"registry_root": f.registry_root,
                "cache_size": f.cache_size,
                "journal_poll_s": f.journal_poll_s,
                "fingerprint": f.fingerprint,
                "membership": f.membership,
                "member": member,
                "backend": self._backend_name,
                "device": self._exec_device}
        return _Executor(self._ctx, spec, member, f.start_timeout_s)

    def add_member(self) -> dict:
        """Grow the fleet by one executor (plus its paired dispatcher
        thread) at runtime — the warm-join path: the newcomer hydrates
        from the shared snapshot + journal before its ready handshake, so
        it serves previously-decided shapes with zero model evals.
        Returns the newcomer's ready info (warm_started, resolution...)."""
        ex = self._spawn_executor()
        with self._mutex:
            if self._closed:
                ex.kill()
                raise RuntimeError("cannot add a member to a closed fleet")
            idx = len(self._executors)
            self._executors.append(ex)
            self._claims.append(None)
            t = threading.Thread(target=self._worker_main, args=(idx,),
                                 name=f"blas-serve-worker-{idx}",
                                 daemon=True)
            self._workers.append(t)
        t.start()
        return dict(ex.ready_info)

    # -- transport ------------------------------------------------------------
    def _prewarm(self, buckets: list) -> None:
        # knob decisions happen inside the executors (each owns the models);
        # a parent-side select_many would be a modelless no-op at best
        return

    def _dispatch(self, bucket, reqs: list, worker_idx: int) -> None:
        ex = self._executors[worker_idx]
        _backend, op, dtype_bytes, dims = bucket.key[:4]
        columns = [[_host(r.operands[i]) for r in reqs]
                   for i in range(len(reqs[0].operands))]
        t_exec = time.monotonic()
        try:
            reply = ex.request("exec", op, _backend, columns, reqs[0].kw,
                               timeout=self.fleet.request_timeout_s)
        except ExecutorDiedError as e:
            self._recover_executor(bucket, reqs, worker_idx, e)
            return
        t_done = time.monotonic()
        if reply[0] != "ok":
            # the executor survived and reported a typed failure (bad
            # operands, a kernel's raise): terminal for this bucket, with
            # the remote traceback chained
            exc = ExecutionFailedError(
                f"fleet executor failed bucket {bucket.key[:4]}: "
                f"{reply[1]}\n--- remote traceback ---\n{reply[2]}")
            n = sum(_resolve_exc(r.future, exc) for r in reqs)
            with self._mutex:
                self.stats.failed += n
                self._pending -= n
                self._done.notify_all()
            return
        out, rinfo = reply[1], reply[2]
        exec_span = float(rinfo.get("exec_s", t_done - t_exec))
        queue_span = sum(t_exec - r.t_submit for r in reqs)
        # telemetry lands on the FRONT END's runtime, booked as the
        # in-process service books it without a retuner: admission
        # control's deadline-feasibility estimates read the bucket's mean
        # queue delay from here
        self.runtime.record_batch(op, dims, dtype_bytes, _backend,
                                  len(reqs), exec_seconds=exec_span,
                                  exec_items=len(reqs),
                                  queue_seconds=queue_span)
        result = torch.from_numpy(out)
        now = time.monotonic()
        resolved = 0
        latency = 0.0
        for i, r in enumerate(reqs):
            if _resolve_result(r.future, result[i]):
                resolved += 1
                latency += now - r.t_submit
        with self._mutex:
            self.stats.completed += resolved
            self.stats.batches += 1
            self.stats.max_batch = max(self.stats.max_batch, len(reqs))
            self.stats.latency_sum += latency
            self.stats.queue_sum += queue_span
            self.stats.exec_sum += exec_span * resolved
            self._pending -= resolved
            self._done.notify_all()

    def _recover_executor(self, bucket, reqs: list, worker_idx: int,
                          cause: ExecutorDiedError) -> None:
        """The process-level mirror of the thread-worker respawn machinery:
        kill the casualty, spawn a replacement into the same slot, requeue
        the bucket — and fail it (typed, with the cause chained) once it
        has burned through 3 recoveries."""
        self._executors[worker_idx].kill()
        bucket.requests = [r for r in reqs if not r.future.done()]
        bucket.recovered += 1
        respawned = False
        if not self._closed:
            try:
                self._executors[worker_idx] = self._spawn_executor()
                respawned = True
            except ExecutorDiedError:
                pass                     # fail the bucket below
        with self._mutex:
            self.stats.worker_respawns += 1
        if not bucket.requests:
            return
        if respawned and bucket.recovered <= 3 and not self._closed:
            self._ready.put(bucket)
            return
        exc = ExecutionFailedError(
            f"bucket {bucket.key[:4]} lost its executor "
            f"{bucket.recovered} time(s); not requeueing again")
        exc.__cause__ = cause
        n = sum(_resolve_exc(r.future, exc) for r in bucket.requests)
        with self._mutex:
            self.stats.failed += n
            self._pending -= n
            self._done.notify_all()

    # -- observability --------------------------------------------------------
    def fleet_stats(self, timeout: float = 10.0) -> list[dict]:
        """One stats dict per live executor (model_evals, cache_len,
        journal_absorbed, warm_started, fingerprint resolution, device...);
        a dead executor contributes ``{"alive": False}``."""
        out = []
        for ex in list(self._executors):
            try:
                reply = ex.request("stats", timeout=timeout)
                d = dict(reply[1])
                d["alive"] = True
            except ExecutorDiedError:
                d = {"alive": False, "member": ex.name}
            out.append(d)
        return out

    def absorb_now(self, timeout: float = 10.0) -> int:
        """Force every executor to poll the shared journal immediately;
        returns the total records absorbed (deterministic tests' hook —
        production members absorb on their idle tick)."""
        total = 0
        for ex in list(self._executors):
            try:
                reply = ex.request("absorb", timeout=timeout)
                total += int(reply[1])
            except ExecutorDiedError:
                pass
        return total

    # -- lifecycle ------------------------------------------------------------
    def close(self, timeout: float = 30.0) -> None:
        with self._mutex:
            already = self._closed
        super().close(timeout=timeout)
        if already:
            return
        per_exec = max(0.5, timeout / max(1, len(self._executors)))
        for ex in self._executors:
            ex.stop(timeout=per_exec)


def _host(x) -> np.ndarray:
    """An operand as a host array for the pipe."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
