"""Crash-safe journaled persistence for runtime warm state.

The decision cache and knob quarantines are what make a restarted server
cheap (zero model evaluations on every previously seen shape),
so losing them to a crash mid-write silently re-inflicts the whole cold
start.  This module is the durability contract those files sit on:

* **Snapshots** are written atomically (temp file in the same directory +
  ``fsync`` + ``os.replace``) so a reader never observes a half-written
  file, and every record inside carries its own CRC32 checksum so a file
  corrupted *after* landing (torn sector, truncation, bit rot) loses only
  the damaged records.
* **Journals** are append-only side files (``<name>.journal``) holding the
  incremental records produced *between* snapshots.  Each append is a
  single flushed write; a crash mid-append tears at most the record being
  written.  Every journal record starts on its own line *prefixed* by a
  newline, so a torn tail is terminated by the next successful append and
  one torn record never swallows its successor.
* **Recovery** (:func:`read_records` / :meth:`DurableStore.load`) is
  tolerant by construction: torn or corrupt lines — bad checksum,
  truncated payload, non-JSON garbage — are dropped and *counted*, never
  raised.  The caller decides what a partial state means; this layer only
  promises that every record it returns was written completely.

File format (line-oriented, human-greppable)::

    #adsala-durable v1
    a1b2c3d4 {"backend":"pallas","op":"gemm",...}
    0f9e8d7c {"quarantine":1,...}

Fault-injection sites (the reference's ``serving/faults.py``): writers fire
``snapshot_write`` / ``journal_append`` through an optional plan before
touching the filesystem.  A plan that raises :class:`TornWrite` makes the
writer persist only the first ``frac`` of the payload *non-atomically* at
the final path before re-raising — the deterministic stand-in for a crash
mid-write that recovery must shrug off.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import zlib
from pathlib import Path

try:  # POSIX only; on other platforms appends fall back to best-effort
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX host
    fcntl = None

__all__ = ["TornWrite", "DurableStore", "JournalFollower", "MAGIC",
           "encode_record", "decode_line", "write_snapshot",
           "append_journal", "read_records", "atomic_write_bytes",
           "is_durable"]

#: first line of every durable snapshot; readers use it to distinguish the
#: checksummed format from legacy plain-JSON files
MAGIC = "#adsala-durable v1"


class TornWrite(RuntimeError):
    """Injected torn write: a durability writer that receives this from its
    fault plan persists only the first ``frac`` of the payload (at the
    FINAL path, non-atomically — the crash it models does not get to run
    the rename) and then re-raises.  Recovery must drop exactly the torn
    records, counted, without raising."""

    def __init__(self, frac: float = 0.5) -> None:
        if not 0.0 <= frac < 1.0:
            raise ValueError("frac must be in [0, 1)")
        super().__init__(f"injected torn write at {frac:.0%} of the payload")
        self.frac = float(frac)


def _crc(payload: bytes) -> str:
    return format(zlib.crc32(payload) & 0xFFFFFFFF, "08x")


def encode_record(record: dict) -> str:
    """One JSON-safe dict → one self-checksummed line (no newline)."""
    payload = json.dumps(record, sort_keys=True, separators=(",", ":"))
    return _crc(payload.encode("utf-8")) + " " + payload


def decode_line(line: str) -> dict | None:
    """Inverse of :func:`encode_record`; None for anything damaged (bad
    checksum, truncated JSON, non-dict payload) — never raises."""
    line = line.strip()
    if not line:
        return None
    crc, sep, payload = line.partition(" ")
    if not sep or _crc(payload.encode("utf-8")) != crc:
        return None
    try:
        obj = json.loads(payload)
    except ValueError:
        return None
    return obj if isinstance(obj, dict) else None


def _fire(faults, site: str, path: Path, data: bytes,
          append: bool) -> None:
    """Run the fault site; a TornWrite lands the truncated payload at the
    final path (appended for journals, clobbered for snapshots) before
    propagating — the write 'happened' as far as the disk is concerned."""
    try:
        faults.fire(site, path=str(path), size=len(data))
    except TornWrite as t:
        cut = int(len(data) * t.frac)
        with open(path, "ab" if append else "wb") as f:
            f.write(data[:cut])
        raise


def atomic_write_bytes(path: str | Path, data: bytes, *,
                       faults=None, site: str = "snapshot_write") -> None:
    """Write-temp + fsync + rename: a reader sees the old bytes or the new
    bytes, never a mix — and a crash anywhere in here leaves the previous
    file intact."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if faults is not None:
        _fire(faults, site, path, data, append=False)
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


def write_snapshot(path: str | Path, records: list[dict], *,
                   faults=None) -> None:
    """Atomically replace ``path`` with a checksummed snapshot of
    ``records`` (magic header + one :func:`encode_record` line each)."""
    lines = [MAGIC]
    lines.extend(encode_record(r) for r in records)
    atomic_write_bytes(path, ("\n".join(lines) + "\n").encode("utf-8"),
                       faults=faults, site="snapshot_write")


@contextlib.contextmanager
def _exclusive(f):
    """``fcntl.flock(LOCK_EX)`` around a file object — a no-op where flock
    is unavailable.  O_APPEND makes each single ``write()`` atomic with
    respect to the *offset*, but one Python-level write can still be split
    into several kernel writes under memory pressure, and two processes
    flushing interleaved chunks tear both records.  The lock serialises
    whole-record appends across processes; a single writer pays one
    uncontended syscall pair."""
    if fcntl is None:
        yield
        return
    fcntl.flock(f.fileno(), fcntl.LOCK_EX)
    try:
        yield
    finally:
        fcntl.flock(f.fileno(), fcntl.LOCK_UN)


def append_journal(path: str | Path, record: dict, *,
                   faults=None, fsync: bool = False) -> None:
    """Append one checksummed record to the journal.  The record is
    *prefixed* with a newline so it terminates any torn previous append;
    the write is flushed (surviving a process SIGKILL) and optionally
    fsynced (surviving power loss — off by default, the journal is an
    incremental optimisation over the last fsynced snapshot).  The append
    is ``flock``-guarded so concurrent writers from several processes (a
    serving fleet sharing one journal) never interleave mid-record."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = ("\n" + encode_record(record)).encode("utf-8")
    if faults is not None:
        _fire(faults, "journal_append", path, data, append=True)
    with open(path, "ab") as f:
        with _exclusive(f):
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())


def read_records(path: str | Path) -> tuple[list[dict], int]:
    """Tolerant read: ``(records, dropped)``.  A missing file is empty, a
    torn/corrupt line is dropped and counted, comment lines (the magic
    header) are skipped — nothing raises."""
    path = Path(path)
    if not path.exists():
        return [], 0
    try:
        text = path.read_bytes().decode("utf-8", errors="replace")
    except OSError:
        return [], 1
    records: list[dict] = []
    dropped = 0
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        rec = decode_line(stripped)
        if rec is None:
            dropped += 1
        else:
            records.append(rec)
    return records, dropped


def is_durable(path: str | Path) -> bool:
    """Does ``path`` start with the durable magic header?  (False for
    missing/unreadable files and legacy plain-JSON payloads.)"""
    try:
        with open(path, "rb") as f:
            head = f.read(len(MAGIC))
    except OSError:
        return False
    return head.decode("utf-8", errors="replace") == MAGIC


class DurableStore:
    """A snapshot + journal pair behind one logical state file.

    :meth:`snapshot` atomically replaces the snapshot and then truncates
    the journal (its records are now absorbed); :meth:`append` journals
    one incremental record; :meth:`load` returns snapshot records followed
    by journal records — journal last, so on key collisions a replayed
    increment wins over the stale snapshot value.  A crash between the
    snapshot rename and the journal truncate merely replays records the
    snapshot already holds, which is harmless as long as the caller's
    import is idempotent (the runtime's is: same key, same knob).
    """

    def __init__(self, path: str | Path, *, faults=None,
                 journal_fsync: bool = False) -> None:
        self.path = Path(path)
        self.journal_path = self.path.with_name(self.path.name + ".journal")
        self._faults = faults
        self._journal_fsync = bool(journal_fsync)
        self._lock = threading.Lock()

    def snapshot(self, records: list[dict]) -> None:
        with self._lock:
            write_snapshot(self.path, records, faults=self._faults)
            try:
                self.journal_path.unlink()
            except FileNotFoundError:
                pass

    def append(self, record: dict) -> None:
        with self._lock:
            append_journal(self.journal_path, record, faults=self._faults,
                           fsync=self._journal_fsync)

    def load(self) -> tuple[list[dict], int]:
        """(snapshot records + journal records, torn records dropped)."""
        with self._lock:
            snap, d_snap = read_records(self.path)
            jour, d_jour = read_records(self.journal_path)
        return snap + jour, d_snap + d_jour

    def follower(self) -> "JournalFollower":
        """A fresh incremental reader over this store's journal."""
        return JournalFollower(self.journal_path)


class JournalFollower:
    """Incremental reader over a (possibly shared) journal file.

    A fleet of serving processes appends decisions to one journal; each
    member absorbs its peers' entries by polling.  The poll must be cheap
    enough to run every scheduler tick, so :meth:`changed` is a single
    ``stat`` (file size vs. bytes already consumed) and :meth:`poll` reads
    only the bytes appended since the previous call.

    Two sharp edges of a live journal are handled here:

    * **Mid-append tails.**  Journal records are newline-*prefixed*, so the
      final record in the file is never newline-terminated and a reader can
      race a writer mid-flush.  A trailing line that fails its checksum is
      *carried* (not dropped) and re-examined on the next poll once more
      bytes land; it is only counted dropped when a later append terminates
      it without it ever having checksummed.
    * **Truncation.**  ``DurableStore.snapshot`` absorbs the journal and
      deletes it.  A follower that observes the file shrink (or vanish)
      resets to offset zero and replays from the start — safe because
      journal absorption is idempotent downstream (same key, same knob).
      Replacement is detected by inode *and* by the file's head bytes: a
      recreated journal can reuse the deleted one's inode at the very size
      already consumed, but its first record's checksum differs.
    """

    #: head-of-file bytes remembered to detect same-inode replacement
    _HEAD_LEN = 64

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self._read_pos = 0          # raw bytes consumed from the file
        self._carry = b""           # undecodable tail, awaiting more bytes
        self._ino: int | None = None    # inode of the file last read from
        self._head = b""            # first bytes of the current generation
        self.dropped = 0            # torn records skipped (terminated ones)

    @property
    def position(self) -> int:
        return self._read_pos

    def changed(self) -> bool:
        """One ``stat``: has the journal grown, shrunk, or been *replaced*
        (snapshot deletes + a later append recreates it — possibly at the
        very size we had consumed) since the last poll?  False for a
        missing file we never read from.  This is a cheap *hint*: a
        recreated file reusing both our inode and our exact consumed size
        is only caught by :meth:`poll`'s head-bytes check (and by the next
        append growing the file) — callers gating on ``changed()`` absorb
        it one tick later."""
        try:
            st = os.stat(self.path)
        except OSError:
            return self._read_pos != 0
        return st.st_size != self._read_pos or st.st_ino != self._ino

    def _reset(self, ino: int | None) -> None:
        self._read_pos = 0
        self._carry = b""
        self._ino = ino
        self._head = b""

    def poll(self) -> list[dict]:
        """Records appended since the previous poll (possibly empty)."""
        try:
            f = open(self.path, "rb")
        except OSError:             # vanished: forget it, replay on return
            if self._read_pos or self._ino is not None:
                self._reset(None)
            return []
        with f:
            # fstat the OPEN fd so identity/size/bytes are one consistent
            # view even if the path is replaced mid-poll
            st = os.fstat(f.fileno())
            if st.st_ino != self._ino or st.st_size < self._read_pos:
                self._reset(st.st_ino)      # new file generation: replay
            elif self._head and f.read(len(self._head)) != self._head:
                self._reset(st.st_ino)      # same inode, different file
            if st.st_size == self._read_pos:
                return []
            if not self._head:
                self._head = f.read(self._HEAD_LEN)
            f.seek(self._read_pos)
            chunk = f.read()
        self._read_pos += len(chunk)
        buf = self._carry + chunk
        *lines, tail = buf.split(b"\n")
        records: list[dict] = []
        for raw in lines:
            s = raw.decode("utf-8", errors="replace").strip()
            if not s or s.startswith("#"):
                continue
            rec = decode_line(s)
            if rec is None:
                self.dropped += 1
            else:
                records.append(rec)
        # The tail has no terminating newline: it is complete iff it
        # checksums (a strict prefix passing CRC32 *and* parsing as JSON
        # is not a practical concern).  Otherwise hold it for next poll.
        self._carry = b""
        s = tail.decode("utf-8", errors="replace").strip()
        if s and not s.startswith("#"):
            rec = decode_line(s)
            if rec is not None:
                records.append(rec)
            else:
                self._carry = tail
        return records
