"""Structured event journal: the durable record of what a run DID.

Port of the JAX package's ``telemetry/events.py``: the same file names,
fields and event kinds, so either package's CLI reads either's journal.

Supervisor restarts, heartbeat DEAD/WEDGED verdicts, chaos injections,
checkpoint save/verify/restore durations, elastic resizes, numerics
skip/rollback decisions — before this module every one of those died in
a log line.  The journal captures them as structured JSONL events so the
``python -m autodist_tpu_torch.telemetry`` CLI (and any later tooling) can
reconstruct a run's timeline without parsing logs.

Layout: ONE writer per process — ``events-<host>-<pid>.jsonl`` under the
run directory (``AUTODIST_TELEMETRY_DIR`` or an explicit
:func:`configure`), append-only, one JSON object per line with
``time``/``kind``/``host``/``pid`` plus event-specific fields.  The
chief merges by reading every ``events-*.jsonl`` in the directory and
sorting by timestamp (:func:`load_run_events`) — no coordination
needed, which is the point: events must survive the process that
emitted them dying mid-write (each line is flushed).

Emission is failure-proof by contract: :func:`emit_event` never raises
(a full disk must not kill training) and is a near-zero-cost no-op when
telemetry is disabled.  Without a run directory events still accumulate
in a bounded in-memory ring (programmatic access in tests and
notebooks).
"""
from __future__ import annotations

import glob
import json
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: in-memory ring size when no run directory is configured.
MEMORY_EVENTS = 4096


class EventJournal:
    """Append-only structured event writer (see module docstring)."""

    def __init__(self, directory: Optional[str] = None,
                 host: Optional[str] = None):
        self._dir = directory
        self._host = host or socket.gethostname()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._memory: deque = deque(maxlen=MEMORY_EVENTS)
        self._fh = None
        self._path: Optional[str] = None
        if directory:
            safe = self._host.replace("/", "_").replace(":", "_")
            self._path = os.path.join(
                directory, f"events-{safe}-{self._pid}.jsonl")

    @property
    def path(self) -> Optional[str]:
        return self._path

    @property
    def events(self) -> List[dict]:
        """The in-memory view (bounded to the last MEMORY_EVENTS)."""
        with self._lock:
            return list(self._memory)

    def emit(self, kind: str, **fields: Any) -> Optional[dict]:
        """Record one event; returns the record, or None on write-path
        failure (never raises — telemetry must not kill training)."""
        record: Dict[str, Any] = {"time": time.time(), "kind": str(kind),
                                  "host": self._host, "pid": self._pid}
        record.update(fields)
        try:
            with self._lock:
                self._memory.append(record)
                if self._path is not None:
                    if self._fh is None:
                        os.makedirs(os.path.dirname(self._path) or ".",
                                    exist_ok=True)
                        self._fh = open(self._path, "a", encoding="utf-8")
                    self._fh.write(json.dumps(record, default=str) + "\n")
                    self._fh.flush()
            return record
        except Exception:
            return None

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


# -- the process journal -----------------------------------------------------

_journal: Optional[EventJournal] = None
_journal_lock = threading.Lock()


def _run_directory() -> Optional[str]:
    from autodist_tpu_torch.const import ENV

    return ENV.AUTODIST_TELEMETRY_DIR.val or None


def get_journal() -> EventJournal:
    """The process-wide journal, created on first use from
    ``AUTODIST_TELEMETRY_DIR`` (in-memory-only when unset)."""
    global _journal
    with _journal_lock:
        if _journal is None:
            _journal = EventJournal(directory=_run_directory())
        return _journal


def configure(directory: Optional[str]) -> EventJournal:
    """(Re)point the process journal at ``directory`` (None = in-memory
    only).  Closes the previous writer."""
    global _journal
    with _journal_lock:
        if _journal is not None:
            _journal.close()
        _journal = EventJournal(directory=directory)
        return _journal


def emit_event(kind: str, **fields: Any) -> Optional[dict]:
    """Emit one structured event on the process journal.  No-op when
    telemetry is disabled; never raises."""
    from autodist_tpu_torch.telemetry.registry import telemetry_enabled

    try:
        if not telemetry_enabled():
            return None
        return get_journal().emit(kind, **fields)
    except Exception:  # pragma: no cover - defensive
        return None


def reset_for_testing() -> None:
    global _journal
    with _journal_lock:
        if _journal is not None:
            _journal.close()
        _journal = None


# -- reading / merging -------------------------------------------------------

def read_events(path: str) -> List[dict]:
    """Parse one events JSONL file (corrupt/truncated lines skipped —
    a writer may have died mid-line)."""
    out: List[dict] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


def load_run_events(run_dir: str,
                    tail: Optional[int] = None) -> List[dict]:
    """The chief-side merge: every ``events-*.jsonl`` under ``run_dir``
    (recursive), time-sorted into one timeline.  ``tail`` keeps only
    the newest N events after the merge — what a crash bundle snapshots
    (``telemetry/flightrec.py``)."""
    merged: List[dict] = []
    for path in glob.glob(os.path.join(run_dir, "**", "events-*.jsonl"),
                          recursive=True):
        merged.extend(read_events(path))
    merged.sort(key=lambda r: r.get("time", 0.0))
    if tail is not None:
        merged = merged[-max(int(tail), 0):]
    return merged
