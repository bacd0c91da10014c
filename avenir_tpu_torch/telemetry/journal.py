"""Append-only JSONL event journal; a copy of ``avenir_tpu/telemetry/journal.py``
on the port's ``utils/locking.FileLock``.

One journal file per traced writer.  Every event is one JSON object on one
line (``{"ev": ..., "ts": ..., ...}``), written append-only and flushed
per event so a wedged or killed run leaves a readable timeline up to the
moment it died.  Three disciplines:

- **single writer**: the journal takes an advisory
  :class:`~avenir_tpu_torch.utils.locking.FileLock` on open and holds it for
  its lifetime, so a second process appending to the same file is
  detected (LockHeldError) instead of interleaving torn lines.
- **rotation-bounded**: when the file would exceed
  ``telemetry.journal.max.mb`` the current file rotates to ``<path>.1``
  (replacing the previous rotation).
- **torn-tail tolerance**: a crash mid-``write`` leaves at most one
  partial final line; :func:`read_events` skips it (and any other
  undecodable line) so every event that was fully written stays
  readable.

A run of several writers writes one shard per writer —
``run-<id>.proc-<k>[-<suffix>].jsonl``, every event stamped with the
writer identity (``stamp``) — and :func:`merge_shards` /
:func:`find_shards` reassemble a run's shards into one time-ordered
view, tolerating torn tails and missing shards.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from avenir_tpu_torch.utils.locking import FileLock


class Journal:
    """Single-writer append-only JSONL sink.

    ``emit`` is thread-safe (serving dispatch threads, feeder workers and
    the pipeline thread all write to the one run journal); cross-process
    exclusion is the FileLock's job.
    """

    def __init__(self, path: str, max_bytes: int = 64 << 20,
                 lock_timeout_s: float = 0.0,
                 stamp: Optional[Dict[str, object]] = None):
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        self.path = path
        self.max_bytes = max(int(max_bytes), 1 << 12)
        # writer-identity stamp merged into EVERY record:
        # proc/host/replica, so a merged fleet view attributes each event
        # to the process that wrote it without parsing shard filenames
        self.stamp = dict(stamp or {})
        self._mutex = threading.Lock()
        # held for the journal's lifetime: a concurrent writer raises
        # LockHeldError here instead of silently interleaving lines
        self._flock = FileLock(path, timeout_s=lock_timeout_s).acquire()
        self._fh = open(path, "a", encoding="utf-8")
        self.events_written = 0

    def emit(self, ev: str, **fields) -> None:
        """Append one event; ``ev`` is the event type, ``ts`` is stamped
        here.  Non-serializable field values degrade to ``repr`` rather
        than losing the event."""
        record: Dict[str, object] = {"ev": ev, "ts": round(time.time(), 6)}
        record.update(self.stamp)
        record.update(fields)
        try:
            line = json.dumps(record, separators=(",", ":"))
        except (TypeError, ValueError):
            line = json.dumps({k: (v if isinstance(
                v, (str, int, float, bool, type(None))) else repr(v))
                for k, v in record.items()}, separators=(",", ":"))
        with self._mutex:
            if self._fh.closed:
                return                     # emit after close: drop, not crash
            if self._fh.tell() + len(line) + 1 > self.max_bytes:
                self._rotate()
            self._fh.write(line)
            self._fh.write("\n")
            self._fh.flush()
            self.events_written += 1

    def _rotate(self) -> None:
        """Roll the full file to ``<path>.1`` (replacing the previous
        rotation) and start fresh — append-only within a file, bounded
        across the pair."""
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        with self._mutex:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()
            self._flock.release()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def iter_events(path: str) -> Iterator[dict]:
    """Yield every decodable event of a journal file in write order.

    A truncated final line (crash mid-write) or any other undecodable
    line is skipped — the journal contract is that every *fully written*
    event survives, not that the file as a whole is one valid document."""
    with open(path, encoding="utf-8", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except ValueError:
                continue                  # torn tail / corrupt line
            if isinstance(event, dict):
                yield event


def read_events(path: str, with_rotated: bool = True) -> List[dict]:
    """All events of a journal (rotated ``<path>.1`` first when present,
    so the list stays in write order across a rotation)."""
    out: List[dict] = []
    if with_rotated and os.path.exists(path + ".1"):
        out.extend(iter_events(path + ".1"))
    out.extend(iter_events(path))
    return out


def latest_journal(directory: str) -> Optional[str]:
    """The most recently modified ``run-*.jsonl`` under ``directory``."""
    try:
        names = [n for n in os.listdir(directory)
                 if n.startswith("run-") and n.endswith(".jsonl")]
    except OSError:
        return None
    if not names:
        return None
    return os.path.join(directory, max(
        names, key=lambda n: os.path.getmtime(os.path.join(directory, n))))


# ---------------------------------------------------------------------------
# shard discovery + federation
# ---------------------------------------------------------------------------

def shard_run_id(name: str) -> Optional[str]:
    """The run id a shard filename encodes: ``run-<id>.jsonl`` (legacy
    single-writer) or ``run-<id>.proc-<k>[-<suffix>].jsonl`` (fleet
    shard); None for anything else (rotations, merged outputs)."""
    if not name.startswith("run-") or not name.endswith(".jsonl"):
        return None
    body = name[len("run-"):-len(".jsonl")]
    return body.split(".proc-", 1)[0] if body else None


def find_shards(directory: str,
                run_id: Optional[str] = None) -> Dict[str, List[str]]:
    """run id → sorted shard paths under ``directory``.  Tolerates
    missing shards trivially (a crashed/preempted worker's shard simply
    is not there); ``run_id`` filters to one run."""
    out: Dict[str, List[str]] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        rid = shard_run_id(name)
        if rid is None or (run_id is not None and rid != run_id):
            continue
        out.setdefault(rid, []).append(os.path.join(directory, name))
    return out


def merge_shards(paths: List[str]) -> List[dict]:
    """One time-ordered fleet view from a run's shard files.

    Reads every shard through :func:`read_events` (rotations included,
    torn tails skipped) and stably sorts by the event's effective time
    (``at`` when a retroactive event carries one, else ``ts``) — within
    one timestamp, shard order then write order is preserved, so a
    parent's ``span.open`` never sorts after its same-tick child from
    the same shard."""
    merged: List[dict] = []
    for path in paths:
        merged.extend(read_events(path))
    merged.sort(key=lambda e: float(e.get("at", e.get("ts", 0.0)) or 0.0))
    return merged


def merge_journals(directory: str, run_id: Optional[str] = None
                   ) -> Tuple[Optional[str], List[str], List[dict]]:
    """(run id, shard paths, merged events) for one run under
    ``directory``: the given ``run_id``, or the run whose newest shard
    was most recently written."""
    shards = find_shards(directory, run_id=run_id)
    if not shards:
        return None, [], []
    if run_id is None:
        run_id = max(shards, key=lambda rid: max(
            os.path.getmtime(p) for p in shards[rid]))
    paths = shards[run_id]
    return run_id, paths, merge_shards(paths)
