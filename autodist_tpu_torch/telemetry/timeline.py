"""Step timelines: per-step records, host-side phase timers, profiler
spans.

Port of the JAX package's ``telemetry/timeline.py``; the records, their
JSONL files and the span names are the same, so either package's CLI
reads either's run directory.  Three instruments, one per time scale:

* :class:`StepRecord` / :class:`StepRecorder` — ONE structured record
  per training step: wall step time, host-phase breakdown (data_load /
  dispatch / blocking_fetch), throughput, and the numerics guard's
  health summary when the host has it, and the cost model's
  PREDICTION for the session's strategy with the fingerprint of its
  schedule IR (``DistributedSession._predict_cost``).
  Records ride a bounded ring buffer and flush periodically as JSONL
  (rotated) into the run directory.
* :func:`host_span` — ``torch.profiler.record_function`` for HOST-side
  phases (data load, step dispatch, blocking fetch): named host events
  in a profiler capture window (AUTODIST_TRACE_STEPS /
  AUTODIST_TRACE_AT).
* :func:`sync_span` — ``record_function("autodist_sync/<name>")`` around
  each sync leg of the bucketed step (``explicit_sync.py``,
  ``overlap.py``, ``quant_ring.py``, the guard): under a capture window
  with CUDA activity the range appears twice in the trace, as the host
  range and as the device range over the kernels it launched, so the
  trace attributes device time to reduce vs guard vs update BY NAME
  (:meth:`~autodist_tpu_torch.telemetry.profiler.LegProfiler.
  parse_trace`).  The prefix is the JAX package's named-scope prefix.
  Without an active profiler a span is a shared no-op context: the step
  pays one check of the profiler's state per span, never a
  RecordFunction.

Cost discipline: when telemetry is disabled, :meth:`StepRecorder.create`
returns None and every call site gates on that one identity check;
enabled, the per-step work is two ``perf_counter`` reads, one dataclass,
and two deque appends.  Nothing here launches a kernel or waits for the
card.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional

from autodist_tpu_torch.telemetry import flightrec
from autodist_tpu_torch.telemetry.registry import telemetry_enabled

#: JSONL rotation threshold: records per ``steps-*.jsonl`` segment.
ROTATE_RECORDS = 50_000
#: ring-buffer capacity (records kept in memory for snapshots/analysis).
RING_RECORDS = 1024
#: flush cadence (records between JSONL appends).
FLUSH_EVERY = 50


@dataclass
class StepRecord:
    """One training step, as the host saw it.

    ``phases`` holds seconds per host-side phase (``data_load``,
    ``dispatch``, ``blocking_fetch``, ...).  Health fields
    (``loss``/``all_finite``/``global_norm``/``loss_scale``/
    ``skipped_steps``) are filled only at points that already pay a
    host sync — fetching them per step would serialize dispatch.
    ``predicted_*``/``sync_bytes`` carry the analytic cost model's
    estimate for the active strategy, stamped once per session — the
    measured-vs-predicted pair every record contributes to calibration.
    """

    step: int
    time_unix: float
    step_time_s: Optional[float] = None
    phases: Dict[str, float] = field(default_factory=dict)
    items_per_s: Optional[float] = None
    tokens_per_s: Optional[float] = None
    loss: Optional[float] = None
    all_finite: Optional[bool] = None
    global_norm: Optional[float] = None
    loss_scale: Optional[float] = None
    skipped_steps: Optional[int] = None
    rolled_back: bool = False
    sync_bytes: Optional[float] = None          # predicted wire B/chip/step
    exposed_bytes: Optional[float] = None       # predicted exposed wire B
    num_collectives: Optional[int] = None
    predicted_step_time_s: Optional[float] = None
    # Short hash of the step's sync-schedule IR:
    # records stamped with a different fingerprint than the checkpoint
    # they resumed from executed a DIFFERENT schedule than planned.
    schedule_fingerprint: Optional[str] = None
    # Emitting host (stamped once per recorder) — the cross-host
    # aggregator keys per-host step-time skew and the trace exporter's
    # per-host tracks on it; None in records written before this field
    # existed.
    host: Optional[str] = None

    def to_json(self) -> str:
        d = {k: v for k, v in asdict(self).items() if v not in (None, {})}
        return json.dumps(d)

    @classmethod
    def from_dict(cls, d: dict) -> "StepRecord":
        known = {f for f in cls.__dataclass_fields__}  # noqa: C401
        return cls(**{k: v for k, v in d.items() if k in known})


class StepRecorder:
    """Per-session step-timeline recorder (see module docstring).

    ``predictor`` is a zero-arg callable returning the cost model's
    estimate dict (``time_s``/``wire_bytes``/``exposed_wire_bytes``/
    ``num_collectives``) or None; it is invoked lazily ONCE (first
    record) so sessions that never run pay nothing.
    """

    def __init__(self, run_id: str, directory: Optional[str] = None,
                 ring: int = RING_RECORDS, flush_every: int = FLUSH_EVERY,
                 rotate_records: int = ROTATE_RECORDS,
                 predictor: Optional[Callable[[], Optional[dict]]] = None):
        import socket

        self.run_id = run_id
        self._host = socket.gethostname()
        self._dir = directory
        self._ring: deque = deque(maxlen=max(ring, 1))
        self._unflushed: List[StepRecord] = []
        self._flush_every = max(int(flush_every), 1)
        self._rotate = max(int(rotate_records), 1)
        self._predictor = predictor
        self._predicted: Any = _UNSET
        self._pending_phases: Dict[str, float] = {}
        self._last_t: Optional[float] = None
        self._last_loss: Optional[float] = None
        self._file_index = 0
        self._lines_in_file = 0
        # Default-registry instrumentation (no-ops when disabled).
        from autodist_tpu_torch.telemetry import registry as _reg
        self._m_steps = _reg.counter(
            "autodist_steps_total", "training steps run by this process")
        self._m_step_time = _reg.histogram(
            "autodist_step_time_seconds", "wall time between step ends")

    @classmethod
    def create(cls, run_id: str,
               predictor: Optional[Callable[[], Optional[dict]]] = None,
               directory: Optional[str] = None,
               **kwargs) -> Optional["StepRecorder"]:
        """The gated constructor: None when telemetry is disabled (call
        sites pay one identity check per step).  ``directory`` defaults
        to ``$AUTODIST_TELEMETRY_DIR/<run_id>`` when that env var is
        set; without it, records stay in the ring (no disk I/O)."""
        if not telemetry_enabled():
            return None
        if directory is None:
            from autodist_tpu_torch.const import ENV
            base = ENV.AUTODIST_TELEMETRY_DIR.val
            if base:
                directory = os.path.join(base, run_id)
        return cls(run_id, directory=directory, predictor=predictor,
                   **kwargs)

    # -- phase timing ------------------------------------------------------
    def add_phase(self, name: str, seconds: float) -> None:
        """Accumulate host time into the NEXT record's phase ``name``."""
        self._pending_phases[name] = \
            self._pending_phases.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_phase(name, time.perf_counter() - t0)

    # -- recording ---------------------------------------------------------
    def _prediction(self) -> Optional[dict]:
        if self._predicted is _UNSET:
            try:
                self._predicted = self._predictor() if self._predictor \
                    else None
            except Exception:   # prediction is advisory, never fatal
                self._predicted = None
        return self._predicted

    def record_step(self, step: int, *, items: Optional[int] = None,
                    tokens: Optional[int] = None) -> StepRecord:
        """Finalize one step: wall time since the previous record, the
        accumulated phases, throughput from ``items``/``tokens``."""
        now = time.perf_counter()
        dt = None if self._last_t is None else now - self._last_t
        self._last_t = now
        pred = self._prediction() or {}
        rec = StepRecord(
            step=int(step), time_unix=time.time(), step_time_s=dt,
            phases=self._pending_phases,
            items_per_s=(items / dt) if items and dt else None,
            tokens_per_s=(tokens / dt) if tokens and dt else None,
            sync_bytes=pred.get("wire_bytes"),
            exposed_bytes=pred.get("exposed_wire_bytes"),
            num_collectives=pred.get("num_collectives"),
            predicted_step_time_s=pred.get("time_s"),
            schedule_fingerprint=pred.get("schedule_fingerprint"),
            host=self._host)
        self._pending_phases = {}
        self._ring.append(rec)
        # Host-phase flight-recorder cursor (flightrec.py): the step
        # boundary is the coarsest progress beacon — the one every path
        # (GSPMD included) gets for free.  The session stamps the
        # matching "enter" before dispatch.
        flightrec.record_cursor("step", kind="phase", event="exit",
                                step=int(step))
        self._m_steps.inc()
        if dt is not None:
            self._m_step_time.observe(dt)
        if self._dir is not None:
            self._unflushed.append(rec)
            if len(self._unflushed) >= self._flush_every:
                self.flush()
        return rec

    def annotate(self, step: Optional[int] = None, **fields: Any) -> None:
        """Attach host-synced observations (loss, GradHealth summary,
        rollback flags) to the record for ``step`` (default: the most
        recent).  Searches the ring from the newest end — annotations
        always target a recent step."""
        target = None
        for rec in reversed(self._ring):
            if step is None or rec.step == step:
                target = rec
                break
        if target is None:
            return
        for k, v in fields.items():
            if hasattr(target, k) and v is not None:
                setattr(target, k, v)
        if fields.get("loss") is not None:
            self._last_loss = float(fields["loss"])

    # -- views -------------------------------------------------------------
    @property
    def records(self) -> List[StepRecord]:
        return list(self._ring)

    @property
    def directory(self) -> Optional[str]:
        return self._dir

    def snapshot(self) -> Optional[dict]:
        """A tiny host-cheap summary of the latest step — what heartbeat
        beacons carry so the monitor can report what a worker was DOING
        when it died (resilience/heartbeat.py).  Never touches device
        arrays."""
        if not self._ring:
            return None
        rec = self._ring[-1]
        out: Dict[str, Any] = {"step": rec.step}
        if rec.step_time_s is not None:
            out["step_time_ms"] = round(rec.step_time_s * 1e3, 3)
        loss = rec.loss if rec.loss is not None else self._last_loss
        if loss is not None:
            out["loss"] = round(float(loss), 6)
        return out

    # -- persistence -------------------------------------------------------
    def _segment_path(self) -> str:
        # Host in the filename (like events-*.jsonl): multi-host runs
        # share one directory over network FS, and two hosts can share
        # a pid.  The loader's steps-*.jsonl glob matches both formats.
        pid = os.getpid()
        safe = self._host.replace("/", "_").replace(":", "_")
        suffix = "" if self._file_index == 0 else f".{self._file_index}"
        return os.path.join(self._dir, f"steps-{safe}-{pid}{suffix}.jsonl")

    def flush(self) -> Optional[str]:
        """Append unflushed records as JSONL; rotates to a new segment
        every ``rotate_records`` lines.  Returns the segment path (None
        when there is no directory/nothing to write); never raises."""
        if self._dir is None or not self._unflushed:
            return None
        f = None
        try:
            os.makedirs(self._dir, exist_ok=True)
            path = self._segment_path()
            f = open(path, "a", encoding="utf-8")
            for rec in self._unflushed:
                f.write(rec.to_json() + "\n")
                self._lines_in_file += 1
                if self._lines_in_file >= self._rotate:
                    f.close()
                    self._file_index += 1
                    self._lines_in_file = 0
                    path = self._segment_path()
                    f = open(path, "a", encoding="utf-8")
            self._unflushed = []
            return path
        except OSError:
            self._unflushed = []
            return None
        finally:
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass


class _Unset:
    pass


_UNSET = _Unset()


# -- profiler spans ----------------------------------------------------------

class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


_profiler_enabled = None


def _profiling() -> bool:
    """Is a profiler active?  (torch's own flag, looked up once.)"""
    global _profiler_enabled
    if _profiler_enabled is None:
        try:
            import torch
            _profiler_enabled = torch.autograd._profiler_enabled
        except ImportError:     # the CLI's hosts: nothing to annotate
            _profiler_enabled = bool
    return _profiler_enabled()


def host_span(name: str):
    """Named host-side span (``torch.profiler.record_function``) for
    phases OUTSIDE the step's device work — a named event when a capture
    window (AUTODIST_TRACE_STEPS / AUTODIST_TRACE_AT) is open; a no-op
    context otherwise."""
    if not _profiling():
        return _NULL_SPAN
    import torch

    return torch.profiler.record_function(name)


def sync_span(name: str):
    """Named range around one sync leg of the step
    (``autodist_sync/<name>``): with a capture window open, a host range
    and, on the card, the device range over its kernels; a no-op context
    otherwise."""
    if not _profiling():
        return _NULL_SPAN
    import torch

    return torch.profiler.record_function(f"autodist_sync/{name}")


def load_step_records(run_dir: str) -> List[StepRecord]:
    """Every ``steps-*.jsonl`` record under ``run_dir`` (recursive),
    step/time-ordered — the CLI's and the calibrator's input."""
    import glob as _glob

    out: List[StepRecord] = []
    for path in sorted(_glob.glob(
            os.path.join(run_dir, "**", "steps-*.jsonl"), recursive=True)):
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(StepRecord.from_dict(json.loads(line)))
                    except (ValueError, TypeError):
                        continue
        except OSError:
            continue
    out.sort(key=lambda r: (r.time_unix, r.step))
    return out
