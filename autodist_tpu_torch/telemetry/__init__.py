"""Unified telemetry: metrics registry, step timelines, event journal,
calibration bridge, flight recorder.

Port of the JAX package's ``telemetry`` package, name for name
(``__all__`` is the JAX package's), with its on-disk formats: the file
names (``steps-<host>-<pid>.jsonl``, ``events-<host>-<pid>.jsonl``,
``legs-*.jsonl``, ``spans-*.jsonl``), the StepRecord fields, the event
kinds, the metric names and bucket bounds, and the ``autodist_sync/``
span vocabulary, so a run directory written by either package is read by
either CLI.

* :mod:`~autodist_tpu_torch.telemetry.registry` — process-local counters
  / gauges / fixed-bound histograms with exact cross-host merge and
  near-zero-cost disabled paths; Prometheus text via
  :func:`render_prometheus`.
* :mod:`~autodist_tpu_torch.telemetry.timeline` — per-step
  :class:`StepRecord` objects (ring-buffered, JSONL-flushed), host-phase
  timers and the ``torch.profiler`` ranges of the sync legs.
* :mod:`~autodist_tpu_torch.telemetry.events` — the structured event
  journal (checkpoint durations, numerics decisions, goodput, serving
  sheds and timeouts).
* :mod:`~autodist_tpu_torch.telemetry.goodput` and
  :mod:`~autodist_tpu_torch.telemetry.calibration` — goodput accounting
  and the regression of cost-model constants from records (the cost
  model is ``strategy/cost_model.py``).
* :mod:`~autodist_tpu_torch.telemetry.flightrec` — progress cursors,
  hang localization and crash bundles.
* :mod:`~autodist_tpu_torch.telemetry.profiler` — leg samples from
  profiler traces, request spans.

``python -m autodist_tpu_torch.telemetry <run_dir>`` summarizes a
recorded run.  Master switch: ``AUTODIST_TELEMETRY`` (default on);
JSONL output lands under ``AUTODIST_TELEMETRY_DIR`` when set.  The
package imports numpy and the standard library only (torch lazily, in
the span helpers and the micro-runs), so the CLI runs on hosts without
an accelerator stack.
"""
from autodist_tpu_torch.telemetry.aggregate import (
    aggregate_run,
    merge_registry_snapshots,
    per_host_step_stats,
    write_registry_snapshot,
)
from autodist_tpu_torch.telemetry.calibration import (
    CalibratedConstants,
    DRIFT_THRESHOLD,
    LEG_DRIFT_THRESHOLD,
    LegCalibration,
    STRAGGLER_THRESHOLD,
    drifted_leg_kinds,
    fit_constants,
    fit_leg_constants,
    leg_drift_reason,
    load_calibration,
    load_default_calibration,
    model_drift_reason,
    predicted_vs_measured,
    prediction_error,
    save_calibration,
    straggler_reason,
)
from autodist_tpu_torch.telemetry.goodput import (
    RECOVERY_BUDGET_S,
    attempt_goodput,
    checkpoint_cadence,
    goodput_from_run,
    recovery_gap_reason,
)
from autodist_tpu_torch.telemetry.events import (
    EventJournal,
    configure as configure_events,
    emit_event,
    get_journal,
    load_run_events,
    read_events,
)
from autodist_tpu_torch.telemetry.flightrec import (
    Cursor,
    CursorRing,
    HangDiagnosis,
    beacon_cursor,
    cursor_line,
    dump_bundle,
    dump_cursors,
    find_bundles,
    install_fatal_handlers,
    latest_cursor,
    localize_hang,
    record_cursor,
    render_hang_report,
)
from autodist_tpu_torch.telemetry.registry import (
    DEFAULT_REGISTRY,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    render_prometheus,
    telemetry_enabled,
)
from autodist_tpu_torch.telemetry.profiler import (
    LegProfiler,
    LegSample,
    configure_spans,
    load_leg_samples,
    load_spans,
    record_span,
    write_leg_samples,
)
from autodist_tpu_torch.telemetry.timeline import (
    StepRecord,
    StepRecorder,
    host_span,
    load_step_records,
    sync_span,
)
from autodist_tpu_torch.telemetry.trace_export import (
    chrome_trace_events,
    export_trace,
)

__all__ = [
    "CalibratedConstants",
    "Cursor",
    "CursorRing",
    "DRIFT_THRESHOLD",
    "DEFAULT_REGISTRY",
    "EventJournal",
    "HangDiagnosis",
    "LEG_DRIFT_THRESHOLD",
    "LegCalibration",
    "LegProfiler",
    "LegSample",
    "MetricsRegistry",
    "RECOVERY_BUDGET_S",
    "STRAGGLER_THRESHOLD",
    "StepRecord",
    "StepRecorder",
    "aggregate_run",
    "attempt_goodput",
    "beacon_cursor",
    "checkpoint_cadence",
    "chrome_trace_events",
    "configure_events",
    "configure_spans",
    "counter",
    "cursor_line",
    "dump_bundle",
    "dump_cursors",
    "drifted_leg_kinds",
    "emit_event",
    "export_trace",
    "find_bundles",
    "fit_constants",
    "fit_leg_constants",
    "gauge",
    "get_journal",
    "goodput_from_run",
    "histogram",
    "host_span",
    "install_fatal_handlers",
    "latest_cursor",
    "leg_drift_reason",
    "load_calibration",
    "load_default_calibration",
    "load_leg_samples",
    "load_run_events",
    "load_spans",
    "load_step_records",
    "localize_hang",
    "merge_registry_snapshots",
    "model_drift_reason",
    "per_host_step_stats",
    "predicted_vs_measured",
    "prediction_error",
    "read_events",
    "record_cursor",
    "record_span",
    "recovery_gap_reason",
    "render_hang_report",
    "render_prometheus",
    "save_calibration",
    "straggler_reason",
    "sync_span",
    "telemetry_enabled",
    "write_leg_samples",
    "write_registry_snapshot",
]
