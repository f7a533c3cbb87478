"""Persisted model store: TunedSubroutine ↔ JSON files (paper Fig. 1a:
"two files containing the configurations together with the production-ready
ML model will be saved for later use at runtime").

Serialisation is structural (no pickle): numpy arrays are encoded as
``{__nd__: 1, dtype, shape, data}`` JSON maps whose ``data`` is the raw
array bytes in base64, so artifacts are portable across Python versions and
safe to load.  This is the reference package's msgpack encoding with JSON
as the container, which keeps the port free of a msgpack dependency.
Writes are atomic (tmp-file + rename) so a preempted install never leaves a
torn artifact.
"""

from __future__ import annotations

import base64
import hashlib
import json
import math
import os
import platform
import re
import tempfile
import threading
from pathlib import Path

import numpy as np

from .durable import (DurableStore, JournalFollower, is_durable,
                      read_records, write_snapshot)
from .knobs import KnobSpace
from .ml import make_model
from .preprocess import PreprocessPipeline
from .tuner import SCHEMA_VERSION, TunedSubroutine

__all__ = ["pack_state", "unpack_state", "save_subroutine",
           "load_subroutine", "subroutine_from_state", "ModelRegistry",
           "host_fingerprint", "fingerprint_slug", "fingerprint_distance",
           "gpu_key"]

#: backend assumed for an artifact whose state or filename names none
_LEGACY_BACKEND = "hopper"


def _artifact_backend(path: Path) -> str:
    return path.stem.split("__", 1)[0] if "__" in path.stem \
        else _LEGACY_BACKEND


def _encode(obj):
    if isinstance(obj, np.ndarray):
        return {"__nd__": 1, "dtype": str(obj.dtype),
                "shape": list(obj.shape),
                "data": base64.b64encode(obj.tobytes()).decode("ascii")}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    raise TypeError(f"cannot serialise {type(obj)}")


def _decode(obj):
    if isinstance(obj, dict) and obj.get("__nd__") == 1:
        return np.frombuffer(base64.b64decode(obj["data"]),
                             dtype=obj["dtype"]).reshape(
            obj["shape"]).copy()
    return obj


def pack_state(state: dict) -> bytes:
    return json.dumps(state, default=_encode,
                      separators=(",", ":")).encode("utf-8")


def unpack_state(data: bytes) -> dict:
    return json.loads(data.decode("utf-8"), object_hook=_decode)


def _atomic_write(path: Path, data: bytes) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def artifact_name(sub: TunedSubroutine) -> str:
    """``{backend}__{op}_b{bytes}.adsala``."""
    return f"{sub.backend}__{sub.op}_b{sub.dtype_bytes}.adsala"


def save_subroutine(sub: TunedSubroutine, root: str | Path) -> Path:
    path = Path(root) / artifact_name(sub)
    _atomic_write(path, pack_state(sub.get_state()))
    return path


def load_subroutine(path: str | Path) -> TunedSubroutine:
    return subroutine_from_state(unpack_state(Path(path).read_bytes()),
                                 origin=str(path))


def subroutine_from_state(state: dict, *,
                          origin: str = "state") -> TunedSubroutine:
    """Build a :class:`TunedSubroutine` from ``TunedSubroutine.get_state()``
    output (numpy arrays and plain Python only) — the port's own artifacts
    after unpacking, or a reference-package artifact's state carried across
    so both packages can be fed the same model."""
    version = int(state.get("version", 1))
    if version > SCHEMA_VERSION:
        raise ValueError(
            f"{origin}: artifact schema v{version} is newer than this "
            f"library's v{SCHEMA_VERSION}; upgrade the library or "
            f"recalibrate")
    knobs = KnobSpace(state["knobs"]["name"], state["knobs"]["candidates"])
    # restore grid-parallelism semantics for block knob spaces
    if knobs.name == "blocks":
        from .knobs import _grid_parallelism
        knobs._parallelism_fn = _grid_parallelism
    pipeline = PreprocessPipeline()
    pipeline.set_state(state["pipeline"])
    model = make_model(state["model_name"])
    model.set_state(state["model"])
    sub = TunedSubroutine(
        op=state["op"], dtype_bytes=int(state["dtype_bytes"]),
        knob_space=knobs, pipeline=pipeline, model=model,
        model_name=state["model_name"], log_target=bool(state["log_target"]),
        backend=str(state.get("backend", _LEGACY_BACKEND)))
    # optional fast-path dominated-candidate analysis (absent on artifacts
    # installed before the compiled decision engine)
    if "fast_live_idx" in state:
        sub.fast_live_idx = np.asarray(state["fast_live_idx"],
                                       dtype=np.int64)
        sub.fast_dims_lo = np.asarray(state["fast_dims_lo"], dtype=np.int64)
        sub.fast_dims_hi = np.asarray(state["fast_dims_hi"], dtype=np.int64)
    # optional confidence-band live set and opt-in KNN coreset
    if "fast_band_idx" in state:
        sub.fast_band_idx = np.asarray(state["fast_band_idx"],
                                       dtype=np.int64)
        sub.fast_band_pct = float(state["fast_band_pct"])
    if "fast_knn_coreset" in state:
        sub.fast_knn_coreset = np.asarray(state["fast_knn_coreset"],
                                          dtype=np.int64)
    if "timer" in state:
        sub.timer = str(state["timer"])
    # registry-stamped artifact generation (absent on artifacts persisted
    # before versioning, or never saved through a ModelRegistry → 0)
    sub.artifact_version = int(state.get("artifact_version", 0))
    return sub


# -- architecture fingerprints ------------------------------------------------
#
# The paper's generality claim (Intel/AMD × MKL/BLIS) is operationalised by
# keying artifact sets on a host *fingerprint*: the handful of platform facts
# that dominate which block config wins (CPU model, core count, cache line).
# One registry directory then serves a heterogeneous fleet — each process
# resolves the sub-registry matching its own hardware, with a deterministic
# nearest-fingerprint fallback for hosts nobody calibrated on.

def _read_first(path: str) -> str:
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            return f.readline().strip()
    except OSError:
        return ""


def _probe_cpu_model() -> str:
    """Human CPU model string: /proc/cpuinfo on Linux, platform fallbacks
    elsewhere.  Empty string when nothing is known."""
    try:
        with open("/proc/cpuinfo", "r", encoding="utf-8",
                  errors="replace") as f:
            for line in f:
                if line.lower().startswith(("model name", "hardware",
                                            "processor\t")):
                    _, _, val = line.partition(":")
                    val = val.strip()
                    if val:
                        return val
    except OSError:
        pass
    return platform.processor() or platform.machine() or ""


def _probe_cache_line() -> int:
    """Coherency line size in bytes (sysfs probe; 64 when unknown — the
    overwhelmingly common value on the paper's platforms)."""
    val = _read_first(
        "/sys/devices/system/cpu/cpu0/cache/index0/coherency_line_size")
    try:
        size = int(val)
    except ValueError:
        size = 0
    return size if size > 0 else 64


def _probe_gpu() -> dict:
    """The first CUDA card's name, compute capability, SM count and memory
    (``torch.cuda.get_device_properties``); empty on a host without one.
    Probing initialises CUDA in the calling process."""
    import torch
    if not torch.cuda.is_available():
        return {}
    props = torch.cuda.get_device_properties(0)
    return {"name": str(props.name),
            "capability": f"{props.major}.{props.minor}",
            "sms": int(props.multi_processor_count),
            "memory_mb": int(props.total_memory) // (1 << 20)}


def gpu_key(fp: dict) -> str:
    """The card a fingerprint names, as one normalised string (empty for a
    host without a card, and for fingerprints written before the card was
    recorded)."""
    gpu = fp.get("gpu") or {}
    if not gpu:
        return ""
    return "|".join(str(gpu.get(k, "")).strip().lower()
                    for k in ("name", "capability", "sms", "memory_mb"))


def host_fingerprint() -> dict:
    """Architecture fingerprint of *this* host, from cheap platform probes.

    Keys: ``cpu_model`` (string, may be empty), ``machine`` (ISA, e.g.
    ``x86_64``/``aarch64``), ``cores`` (``os.cpu_count()``), ``cache_line``
    (bytes) and ``gpu``: the first CUDA card's ``name``, ``capability``,
    ``sms`` and ``memory_mb``, or an empty dict on a host without one.
    Stable across processes on one host; JSON-safe."""
    return {
        "cpu_model": _probe_cpu_model(),
        "machine": platform.machine() or "",
        "cores": int(os.cpu_count() or 1),
        "cache_line": _probe_cache_line(),
        "gpu": _probe_gpu(),
    }


def fingerprint_slug(fp: dict) -> str:
    """Deterministic directory-safe slug for a fingerprint: a normalised
    ``{machine}-{cores}c-{cache_line}l-{model hash}`` so two processes on
    identical hardware always resolve the same sub-registry, followed by
    ``-g{card hash}`` where the fingerprint names a card (a fingerprint
    without one keeps the reference package's slug)."""
    model = str(fp.get("cpu_model", "")).lower()
    digest = hashlib.sha256(model.encode("utf-8")).hexdigest()[:8]
    machine = re.sub(r"[^a-z0-9]+", "", str(fp.get("machine", "")).lower()) \
        or "unknown"
    slug = (f"{machine}-{int(fp.get('cores', 0) or 0)}c-"
            f"{int(fp.get('cache_line', 0) or 0)}l-{digest}")
    card = gpu_key(fp)
    if card:
        slug += "-g" + hashlib.sha256(card.encode("utf-8")).hexdigest()[:8]
    return slug


def fingerprint_distance(a: dict, b: dict) -> float:
    """Deterministic dissimilarity score between two fingerprints (0 for an
    exact match).  Weighted so the facts that change which knob wins
    dominate: a different card (or a card against none) is infinitely
    far, so no resolution crosses it; then a different CPU model outweighs
    everything else, a different ISA is next, then |log2| of the
    core-count ratio (8→16 cores is as far as 16→32), then cache-line
    mismatch as a tie-breaker."""
    if gpu_key(a) != gpu_key(b):
        return math.inf
    score = 0.0
    if str(a.get("cpu_model", "")).lower() != \
            str(b.get("cpu_model", "")).lower():
        score += 100.0
    if str(a.get("machine", "")) != str(b.get("machine", "")):
        score += 50.0
    ca = max(1, int(a.get("cores", 1) or 1))
    cb = max(1, int(b.get("cores", 1) or 1))
    score += abs(math.log2(ca / cb))
    if int(a.get("cache_line", 0) or 0) != int(b.get("cache_line", 0) or 0):
        score += 0.5
    return score


class ModelRegistry:
    """Directory of installed, backend-tagged subroutine artifacts.

    A process hydrates its per-backend model sets at startup with a single
    ``registry.load_into(runtime)`` — every artifact carries its backend tag,
    so one directory can hold several backends' sets side by side.
    """

    #: sidecar mapping artifact filename -> last stamped version.  Kept
    #: separate from the artifacts so the counter survives a delete +
    #: reinstall of a model file — versions never move backwards.
    VERSIONS = "versions.json"

    def __init__(self, root: str | Path, *, faults=None) -> None:
        self.root = Path(root)
        self._version_lock = threading.Lock()
        #: optional fault plan (chaos harness)
        self._faults = faults
        #: (path, error) pairs from the most recent :meth:`load_into` —
        #: artifacts that failed to load and were skipped
        self.last_load_errors: list[tuple[str, str]] = []
        #: recovery accounting of the most recent :meth:`load_decision_cache`
        self.last_recovery: dict[str, object] = {}
        #: how the most recent :meth:`resolve_fingerprint` chose its
        #: sub-registry: {"mode": exact|nearest|flat, "slug", "distance"}
        self.last_fingerprint_resolution: dict[str, object] = {}
        self._decision_store: DurableStore | None = None

    @property
    def versions_path(self) -> Path:
        return self.root / self.VERSIONS

    def _read_versions(self) -> dict[str, int]:
        path = self.versions_path
        if not path.exists():
            return {}
        try:
            if is_durable(path):
                # checksummed snapshot: one {"versions": {...}} record; a
                # torn record reads as empty (versions restart at 0 —
                # caches stamped by the lost generations are then merely
                # dropped at warm start, never replayed wrongly)
                out: dict[str, int] = {}
                for rec in read_records(path)[0]:
                    for k, v in rec.get("versions", {}).items():
                        out[str(k)] = max(out.get(str(k), 0), int(v))
                return out
            # legacy plain-JSON sidecar (pre-durable stores)
            return {str(k): int(v)
                    for k, v in json.loads(path.read_text()).items()}
        except (ValueError, OSError):
            return {}

    def artifact_version(self, name: str) -> int:
        """Last version stamped for this artifact filename (0 = never)."""
        return self._read_versions().get(name, 0)

    def save(self, sub: TunedSubroutine) -> Path:
        """Persist one artifact, stamping the next monotonically increasing
        version for its filename onto ``sub.artifact_version`` first.  A
        reinstalled/retuned model therefore never shares a version with its
        predecessor, and decision-cache entries recorded against the old
        generation are rejected at warm start."""
        name = artifact_name(sub)
        with self._version_lock:
            versions = self._read_versions()
            # never move backwards, even if the sub was stamped elsewhere
            versions[name] = max(versions.get(name, 0),
                                 int(getattr(sub, "artifact_version", 0))) + 1
            sub.artifact_version = versions[name]
            write_snapshot(self.versions_path, [{"versions": versions}],
                           faults=self._faults)
        return save_subroutine(sub, self.root)

    def load_all(self, backend: str | None = None) -> list[TunedSubroutine]:
        """Load artifacts, filtering by the filename's backend tag *before*
        unpacking — one backend's bad/newer artifact can't break another's
        load, and startup only unpickles what it asked for."""
        if not self.root.exists():
            return []
        paths = sorted(self.root.glob("*.adsala"))
        if backend is not None:
            paths = [p for p in paths if _artifact_backend(p) == backend]
        return [load_subroutine(p) for p in paths]

    def backends(self) -> tuple[str, ...]:
        """Backend tags present in the store (from filenames)."""
        if not self.root.exists():
            return ()
        return tuple(sorted({_artifact_backend(p)
                             for p in self.root.glob("*.adsala")}))

    def load_into(self, runtime, backend: str | None = None) -> int:
        """Hydrate ``runtime`` with every (matching) artifact.  Each
        ``register`` compiles the artifact's fast-path predictor up front,
        so a served process pays the fold cost at startup, not on its
        first uncached call.

        Per-artifact fault isolation: one corrupt/unreadable artifact is
        skipped (recorded in :attr:`last_load_errors`) instead of aborting
        the whole hydration — the runtime serves the models that DID load
        and falls back to default knobs for the one that didn't.  Returns
        the number of artifacts registered."""
        self.last_load_errors = []
        if not self.root.exists():
            return 0
        paths = sorted(self.root.glob("*.adsala"))
        if backend is not None:
            paths = [p for p in paths if _artifact_backend(p) == backend]
        n = 0
        for p in paths:
            try:
                if self._faults is not None:
                    self._faults.fire("artifact_load", path=str(p))
                runtime.register(load_subroutine(p))
                n += 1
            except Exception as e:       # noqa: BLE001 — skip, keep loading
                self.last_load_errors.append(
                    (str(p), f"{type(e).__name__}: {e}"))
        return n

    # -- warm-start decision cache -------------------------------------------
    #: filename of the persisted runtime decision cache (beside the models)
    DECISION_CACHE = "decision_cache.json"

    #: decision-cache snapshot schema written by this library (durable
    #: format; v1/v2 legacy plain-JSON payloads still load)
    DECISION_CACHE_VERSION = 3

    @property
    def decision_cache_path(self) -> Path:
        return self.root / self.DECISION_CACHE

    def _cache_store(self) -> DurableStore:
        store = self._decision_store
        if store is None:
            store = self._decision_store = DurableStore(
                self.decision_cache_path, faults=self._faults)
        return store

    def save_decision_cache(self, runtime) -> Path:
        """Persist the runtime's LRU decision cache beside the artifacts so a
        restarted server warm-starts past the cold model evaluations.

        Snapshot v3 is the durable checksummed format (one header record +
        one record per :meth:`~repro_torch.core.runtime.AdsalaRuntime.export_cache`
        entry); a successful snapshot absorbs and truncates the incremental
        decision journal.  Every entry carries the ``artifact_version`` of
        the subroutine that made the decision, so a restart after a
        reinstall or an online retune rejects the stale entries instead of
        replaying the predecessor model's knobs with zero evals and no
        warning."""
        header = {"header": 1, "version": self.DECISION_CACHE_VERSION}
        self._cache_store().snapshot([header] + runtime.export_cache())
        return self.decision_cache_path

    def journal_decision(self, record: dict) -> None:
        """Append one incremental decision/quarantine record (an
        ``export_cache``-shaped dict) to the decision journal — the
        crash-safety increment between snapshots.  Wire this as
        ``runtime.decision_journal`` so every new cached decision survives
        a crash that never reached the next :meth:`save_decision_cache`."""
        self._cache_store().append(record)

    def load_decision_cache(self, runtime) -> int:
        """Warm-start ``runtime`` from a persisted decision cache; returns
        the number of imported decisions (0 when no cache file exists).

        Recovery is corruption-tolerant: torn/corrupt records in the
        snapshot or journal are dropped (counted in :attr:`last_recovery`
        and, for malformed-but-checksummed records, in the runtime's
        ``import_drops_corrupt``) and a fully unreadable legacy payload
        degrades to a cold start — a crashed writer must never stop the
        server from starting.  A *well-formed* snapshot from a NEWER
        library still raises ``ValueError``: that is an operator error
        (downgrade), not corruption.  Journal records are imported after
        the snapshot's, so incremental updates win on key collisions.
        v1 caches (persisted before artifact versioning) load with their
        entries treated as version 0 — they only warm-start version-0
        (never-registry-stamped) subroutines."""
        path = self.decision_cache_path
        self.last_recovery = {"snapshot_records": 0, "journal_records": 0,
                              "dropped_records": 0, "cold_start": False}
        entries: list[dict] = []
        if path.exists():
            if is_durable(path):
                snap, dropped = read_records(path)
                headers = [r for r in snap if r.get("header")]
                if headers and int(headers[0].get("version", 0)) > \
                        self.DECISION_CACHE_VERSION:
                    raise ValueError(
                        f"{path}: decision-cache snapshot "
                        f"v{headers[0]['version']} is newer than this "
                        f"library's v{self.DECISION_CACHE_VERSION}")
                entries = [r for r in snap if not r.get("header")]
                self.last_recovery["dropped_records"] += dropped
            else:
                try:
                    payload = json.loads(path.read_text())
                except ValueError:
                    # torn legacy write / garbage file: cold start, never
                    # propagate — warm start is an optimisation
                    payload = None
                if isinstance(payload, dict):
                    if int(payload.get("version", 1)) not in (1, 2):
                        raise ValueError(
                            f"{path}: unknown decision-cache version "
                            f"{payload.get('version')!r}")
                    entries = [e for e in payload.get("entries") or []
                               if isinstance(e, dict)]
                else:
                    self.last_recovery["cold_start"] = True
                    self.last_recovery["dropped_records"] += 1
        self.last_recovery["snapshot_records"] = len(entries)
        journal, j_dropped = read_records(self._cache_store().journal_path)
        self.last_recovery["journal_records"] = len(journal)
        self.last_recovery["dropped_records"] += j_dropped
        entries.extend(journal)
        if not entries:
            return 0
        return runtime.import_cache(entries)

    def journal_follower(self) -> JournalFollower:
        """Incremental reader over this registry's decision journal — the
        fleet-coherence poll: every serving process tails the shared
        journal and absorbs the decisions/quarantines its peers append."""
        return self._cache_store().follower()

    # -- fingerprint-keyed sub-registries ------------------------------------
    #: subdirectory holding one sub-registry per architecture fingerprint
    ARCH_DIR = "arch"

    #: sidecar inside each sub-registry recording the fingerprint it was
    #: calibrated for (written by :meth:`for_fingerprint`)
    FINGERPRINT = "fingerprint.json"

    def for_fingerprint(self, fp: dict | None = None, *,
                        create: bool = False) -> "ModelRegistry":
        """The sub-registry keyed by ``fp`` (default: this host's probe).

        With ``create=True`` the directory and its ``fingerprint.json``
        sidecar are written — this is how a calibration/install job claims
        the slot for the architecture it ran on.  The returned registry is
        a full :class:`ModelRegistry` (own artifacts, versions sidecar,
        decision cache + shared journal)."""
        fp = dict(fp or host_fingerprint())
        sub = ModelRegistry(self.root / self.ARCH_DIR / fingerprint_slug(fp),
                            faults=self._faults)
        if create:
            write_snapshot(sub.root / self.FINGERPRINT,
                           [{"fingerprint": fp}], faults=self._faults)
        return sub

    def fingerprints(self) -> list[tuple[str, dict]]:
        """Every calibrated ``(slug, fingerprint)`` under ``arch/``, sorted
        by slug.  Sub-registries with a missing/corrupt sidecar are skipped
        (they cannot be matched, so they cannot be served)."""
        arch = self.root / self.ARCH_DIR
        if not arch.is_dir():
            return []
        out: list[tuple[str, dict]] = []
        for child in sorted(arch.iterdir()):
            sidecar = child / self.FINGERPRINT
            if not child.is_dir() or not sidecar.exists():
                continue
            for rec in read_records(sidecar)[0]:
                fp = rec.get("fingerprint")
                if isinstance(fp, dict):
                    out.append((child.name, fp))
                    break
        return out

    def resolve_fingerprint(self, fp: dict | None = None) -> "ModelRegistry":
        """The sub-registry a serving process on host ``fp`` should load.

        Resolution order (recorded in :attr:`last_fingerprint_resolution`):

        1. **exact** — a calibrated sub-registry whose slug matches ``fp``;
        2. **nearest** — among the calibrated sub-registries of the *same
           card* as ``fp`` (or, for a host without one, among those
           without one), the one minimising :func:`fingerprint_distance`
           (ties broken by slug) — an unseen host borrows the closest
           architecture's models rather than starting knob-blind, but never
           a model timed on another card or on none;
        3. **flat** — no such sub-registry: the registry root itself (the
           single-architecture layout every prior PR used), as when
           ``arch/`` holds nothing at all.
        """
        fp = dict(fp or host_fingerprint())
        slug = fingerprint_slug(fp)
        known = self.fingerprints()
        for cand_slug, _cand_fp in known:
            if cand_slug == slug:
                self.last_fingerprint_resolution = {
                    "mode": "exact", "slug": slug, "distance": 0.0,
                    "gpu": gpu_key(fp)}
                return ModelRegistry(self.root / self.ARCH_DIR / slug,
                                     faults=self._faults)
        same_card = [(s, f, fingerprint_distance(fp, f)) for s, f in known
                     if gpu_key(f) == gpu_key(fp)]
        if same_card:
            best_slug, _best_fp, best_d = min(same_card,
                                              key=lambda t: (t[2], t[0]))
            self.last_fingerprint_resolution = {
                "mode": "nearest", "slug": best_slug, "distance": best_d,
                "gpu": gpu_key(fp)}
            return ModelRegistry(self.root / self.ARCH_DIR / best_slug,
                                 faults=self._faults)
        self.last_fingerprint_resolution = {
            "mode": "flat", "slug": "", "distance": 0.0, "gpu": gpu_key(fp),
            "skipped": len(known)}
        return self
