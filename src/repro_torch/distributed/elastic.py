"""Elastic membership of a serving fleet (the ``FleetMembership`` part of
the reference package's ``distributed/elastic.py``; its mesh helpers,
``best_mesh``, ``reshard`` and ``abstract_like``, wait for the distributed
slice of the port).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

from repro_torch.core.durable import atomic_write_bytes

__all__ = ["FleetMembership"]


class FleetMembership:
    """File-based membership registry for a serving fleet.

    One JSON file per member under ``root`` (conventionally
    ``<registry>/members/``), written atomically so a reader never sees a
    torn record.  Liveness is heartbeat-based: a member rewrites its file
    (fresh wall-clock stamp) on its poll tick, and :meth:`members` treats
    anything older than ``stale_s`` as dead — a SIGKILLed executor
    disappears from the roster without anyone cleaning up after it.  This
    is deliberately the weakest coordination primitive that works on a
    shared filesystem (local fleet today, NFS-mounted multi-host registry
    tomorrow): no daemon, no locks, idempotent registration.
    """

    def __init__(self, root: str | Path, *, stale_s: float = 30.0) -> None:
        if stale_s <= 0:
            raise ValueError("stale_s must be > 0")
        self.root = Path(root)
        self.stale_s = float(stale_s)

    def _path(self, name: str) -> Path:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in str(name)) or "member"
        return self.root / f"{safe}.json"

    def register(self, name: str, **meta) -> Path:
        """(Re)announce a member; extra keyword facts (pid, fingerprint
        slug, ...) ride along in its record."""
        record = {"name": str(name), "pid": os.getpid(),
                  "t": time.time(), **meta}
        path = self._path(name)
        atomic_write_bytes(path, json.dumps(
            record, sort_keys=True).encode("utf-8"))
        return path

    def heartbeat(self, name: str, **meta) -> None:
        """Refresh the member's liveness stamp (same write as register)."""
        self.register(name, **meta)

    def members(self, *, live_only: bool = True) -> list[dict]:
        """Current roster, sorted by name; with ``live_only`` (default)
        members whose heartbeat is older than ``stale_s`` are dropped.
        Torn/corrupt records are skipped, never raised."""
        if not self.root.is_dir():
            return []
        now = time.time()
        out = []
        for path in sorted(self.root.glob("*.json")):
            try:
                rec = json.loads(path.read_text())
            except (ValueError, OSError):
                continue
            if not isinstance(rec, dict):
                continue
            if live_only and now - float(rec.get("t", 0)) > self.stale_s:
                continue
            out.append(rec)
        return out

    def deregister(self, name: str) -> None:
        try:
            self._path(name).unlink()
        except FileNotFoundError:
            pass
