"""Cross-host trace export: one run directory → one Chrome-trace JSON.

A recorded run scatters its story across four JSONL streams — StepRecord
timelines (host phases), leg samples (measured sync legs), the event
journal (supervisor / chaos / saver / numerics events), and serving
request spans — each chief-mergeable on its own but never visible as ONE
timeline.  :func:`export_trace` merges them into a single
`Chrome Trace Event Format <https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
JSON file (the ``traceEvents`` array form) that ``chrome://tracing`` and
`Perfetto <https://ui.perfetto.dev>`_ open directly:

* one **pid row per host** (Perfetto renders pids as process groups, so
  a 4-host run shows four aligned tracks);
* per host, a ``train/steps`` thread of complete (``ph: "X"``) step
  events with the host-phase breakdown (data_load / dispatch /
  blocking_fetch) nested inside each step's window, annotated with
  loss/fingerprint/throughput in ``args``;
* a ``sync/legs (measured)`` thread of leg-sample events (micro-run or
  trace-derived timings, laid out at their measurement timestamps) with
  kind/alg/bytes/predicted-vs-measured in ``args``;
* an ``events`` thread of instant (``ph: "i"``) journal events;
* a ``serving/<track>`` thread per span name family (queue_wait /
  prefill / decode / request / route), each event carrying its
  propagated ``trace_id`` so one request's spans correlate across
  router and replica hosts.

Timestamps are microseconds relative to the run's earliest record (the
``ts``/``dur`` contract), so traces from any wall-clock era align at 0.
Pure stdlib + the sibling telemetry readers — torch-free like the rest
of the CLI (``python -m autodist_tpu_torch.telemetry <run_dir>
--export-trace``).  A port of the JAX package's
``telemetry/trace_export.py``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

#: synthetic thread ids per track family (stable ordering in the UI).
TID_STEPS = 1
TID_PHASES = 2
TID_LEGS = 3
TID_EVENTS = 4
TID_SERVING_BASE = 10

_UNKNOWN_HOST = "host-0"


def _us(t: float, t0: float) -> float:
    return round((t - t0) * 1e6, 3)


class _Pids:
    """host name → stable synthetic pid, with process_name metadata."""

    def __init__(self, events: List[dict]):
        self._events = events
        self._pids: Dict[str, int] = {}

    def pid(self, host: Optional[str]) -> int:
        host = host or _UNKNOWN_HOST
        if host not in self._pids:
            pid = len(self._pids) + 1
            self._pids[host] = pid
            self._events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": host}})
        return self._pids[host]


def _thread_meta(events: List[dict], pid: int, tid: int,
                 name: str, seen: set) -> None:
    if (pid, tid) in seen:
        return
    seen.add((pid, tid))
    events.append({"name": "thread_name", "ph": "M", "pid": pid,
                   "tid": tid, "args": {"name": name}})


def chrome_trace_events(records: Sequence[Any] = (),
                        leg_samples: Sequence[Any] = (),
                        journal: Sequence[dict] = (),
                        spans: Sequence[dict] = ()) -> List[dict]:
    """Merge the four streams into one ``traceEvents`` list (see module
    docstring).  Pure function of already-loaded data — the unit the
    golden test locks down."""
    out: List[dict] = []
    pids = _Pids(out)
    threads: set = set()

    # Common time origin: earliest wall timestamp across every stream.
    starts: List[float] = []
    for r in records:
        t = getattr(r, "time_unix", None)
        st = getattr(r, "step_time_s", None) or 0.0
        if t:
            starts.append(float(t) - float(st))
    starts += [float(e["time"]) for e in journal if e.get("time")]
    starts += [float(s["start_unix"]) for s in spans
               if s.get("start_unix")]
    starts += [float(getattr(s, "time_unix", 0.0)) for s in leg_samples
               if getattr(s, "time_unix", 0.0)]
    t0 = min(starts) if starts else 0.0

    # -- training steps + nested host phases ------------------------------
    for r in records:
        t_end = getattr(r, "time_unix", None)
        dt = getattr(r, "step_time_s", None)
        if not t_end or not dt:
            continue
        pid = pids.pid(getattr(r, "host", None))
        _thread_meta(out, pid, TID_STEPS, "train/steps", threads)
        args: Dict[str, Any] = {"step": getattr(r, "step", None)}
        for k in ("loss", "items_per_s", "tokens_per_s",
                  "schedule_fingerprint", "predicted_step_time_s",
                  "skipped_steps"):
            v = getattr(r, k, None)
            if v is not None:
                args[k] = v
        start = float(t_end) - float(dt)
        out.append({"name": f"step {getattr(r, 'step', '?')}",
                    "cat": "train", "ph": "X", "pid": pid,
                    "tid": TID_STEPS, "ts": _us(start, t0),
                    "dur": round(float(dt) * 1e6, 3), "args": args})
        # Phases have durations, not offsets: lay them out sequentially
        # inside the step window (their sum is <= the step time; the
        # remainder is device execution the host did not observe).
        cursor = start
        _thread_meta(out, pid, TID_PHASES, "train/host-phases", threads)
        for name, sec in sorted((getattr(r, "phases", None) or {}).items()):
            if not sec or sec <= 0:
                continue
            out.append({"name": name, "cat": "phase", "ph": "X",
                        "pid": pid, "tid": TID_PHASES,
                        "ts": _us(cursor, t0),
                        "dur": round(float(sec) * 1e6, 3),
                        "args": {"step": getattr(r, "step", None)}})
            cursor += float(sec)

    # -- measured sync legs ------------------------------------------------
    cursor_by_host: Dict[str, float] = {}
    for s in leg_samples:
        host = getattr(s, "host", None)
        pid = pids.pid(host)
        _thread_meta(out, pid, TID_LEGS, "sync/legs (measured)", threads)
        t = getattr(s, "time_unix", 0.0) or t0
        # Samples measured in one batch share a timestamp: advance a
        # per-host cursor so they render side by side, not stacked.
        cursor = max(cursor_by_host.get(host or "", 0.0), float(t))
        dur = float(getattr(s, "measured_s", 0.0) or 0.0)
        args = {"kind": getattr(s, "kind", ""),
                "alg": getattr(s, "alg", ""),
                "nbytes": getattr(s, "nbytes", 0),
                "slot": getattr(s, "slot", -1),
                "compressor": getattr(s, "compressor", ""),
                "source": getattr(s, "source", ""),
                "schedule_fingerprint":
                    getattr(s, "schedule_fingerprint", "")}
        pred = getattr(s, "predicted_s", None)
        if pred is not None:
            args["predicted_s"] = pred
        out.append({"name": getattr(s, "leg_id", "leg"), "cat": "leg",
                    "ph": "X", "pid": pid, "tid": TID_LEGS,
                    "ts": _us(cursor, t0),
                    "dur": round(dur * 1e6, 3), "args": args})
        cursor_by_host[host or ""] = cursor + dur

    # -- journal events (instants) ----------------------------------------
    for e in journal:
        t = e.get("time")
        if not t:
            continue
        pid = pids.pid(e.get("host"))
        _thread_meta(out, pid, TID_EVENTS, "events", threads)
        args = {k: v for k, v in e.items()
                if k not in ("time", "kind", "host")}
        out.append({"name": str(e.get("kind", "event")), "cat": "event",
                    "ph": "i", "s": "t", "pid": pid, "tid": TID_EVENTS,
                    "ts": _us(float(t), t0), "args": args})

    # -- serving request spans --------------------------------------------
    serving_tids: Dict[str, int] = {}
    for s in spans:
        t = s.get("start_unix")
        if t is None:
            continue
        pid = pids.pid(s.get("host"))
        name = str(s.get("name", "span"))
        family = name.split("/", 1)[0]
        tid = serving_tids.setdefault(
            family, TID_SERVING_BASE + len(serving_tids))
        _thread_meta(out, pid, tid, f"serving/{family}", threads)
        args = dict(s.get("args") or {})
        if s.get("trace_id"):
            args["trace_id"] = s["trace_id"]
        out.append({"name": name, "cat": "serving", "ph": "X",
                    "pid": pid, "tid": tid, "ts": _us(float(t), t0),
                    "dur": round(float(s.get("dur_s", 0.0)) * 1e6, 3),
                    "args": args})
    return out


def export_trace(run_dir: str, out_path: Optional[str] = None
                 ) -> Optional[str]:
    """Load every stream under ``run_dir``, merge, and write the
    Chrome-trace file (default ``<run_dir>/trace.json``).  Returns the
    path, or None when the directory holds nothing to export."""
    from autodist_tpu_torch.telemetry.events import load_run_events
    from autodist_tpu_torch.telemetry.profiler import (
        load_leg_samples,
        load_spans,
    )
    from autodist_tpu_torch.telemetry.timeline import load_step_records

    records = load_step_records(run_dir)
    legs = load_leg_samples(run_dir)
    journal = load_run_events(run_dir)
    spans = load_spans(run_dir)
    events = chrome_trace_events(records, legs, journal, spans)
    if not any(e.get("ph") != "M" for e in events):
        return None
    payload = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "exporter": "autodist_tpu_torch.telemetry.trace_export",
            "run_dir": os.path.abspath(run_dir),
            "streams": {"step_records": len(records),
                        "leg_samples": len(legs),
                        "journal_events": len(journal),
                        "serving_spans": len(spans)},
        },
    }
    path = out_path or os.path.join(run_dir, "trace.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
        f.write("\n")
    return path
