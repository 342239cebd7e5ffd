"""Telemetry pass: is the cost model still telling the truth?

The analyzer's other passes reason about what a strategy WILL do; this
one closes the loop with what a run actually DID.  Feed
``analyze(..., telemetry=...)`` a measurement summary — most usefully
:func:`autodist_tpu_torch.telemetry.calibration.predicted_vs_measured` over a
recorded run's StepRecords — and the pass checks the analytic cost
model's step-time prediction against the measurement.  Inert without
provenance (the ``elastic`` pass pattern): a plain pre-flight run never
sees these rules.

Rules (docs/observability.md):

* ``telemetry/model-drift`` (WARN) — measured step time diverges from
  the model's prediction by more than
  :data:`~autodist_tpu_torch.telemetry.calibration.DRIFT_THRESHOLD` in either
  direction.  The reason string is the SHARED pure rule
  :func:`~autodist_tpu_torch.telemetry.calibration.model_drift_reason` (the
  ``bucket_drop_reason`` pattern), so the lint, the CLI report, and any
  runtime check can never disagree about what counts as drift.  An
  AutoStrategy search ranked by a drifted model picks wrong — the fix
  is ``telemetry.calibration.fit_constants`` on the run's records.
* ``telemetry/no-measurement`` (INFO) — telemetry provenance was passed
  but holds no usable measured/predicted pair (e.g. a run recorded with
  the cost predictor unavailable); the drift check could not run.
* ``telemetry/leg-drift`` (WARN) — one leg KIND's measured time (from
  the schedule-aware profiler's LegSamples) diverges from the
  leg-priced prediction beyond
  :data:`~autodist_tpu_torch.telemetry.calibration.LEG_DRIFT_THRESHOLD`.
  Shared pure rule
  :func:`~autodist_tpu_torch.telemetry.calibration.leg_drift_reason` — the
  CLI compare report prints the identical string.  Whole-step drift
  says "something is off"; leg drift says WHICH leg kind.
* ``telemetry/straggler`` (WARN) — the slowest host's median step time
  exceeds
  :data:`~autodist_tpu_torch.telemetry.calibration.STRAGGLER_THRESHOLD` x
  the fastest host's.  Shared pure rule
  :func:`~autodist_tpu_torch.telemetry.calibration.straggler_reason` (the
  cross-host aggregator surfaces the same verdict as a gauge).

``telemetry`` provenance dict keys: ``measured_step_time_s``,
``predicted_step_time_s`` (both seconds; the
``predicted_vs_measured()`` output is accepted directly), optional
``threshold`` override; ``leg_kinds`` (``{kind: {"measured_s": ...,
"predicted_s": ...}}`` — per-leg-kind totals from profiler samples);
``per_host_step_time_s`` (``{host: median_s}``) or an
``aggregate_run()`` output's ``hosts`` mapping.
"""
from __future__ import annotations

from typing import List

from autodist_tpu_torch.analysis.analyzer import AnalysisContext, register_pass
from autodist_tpu_torch.analysis.diagnostics import Diagnostic, Severity, diag


@register_pass("telemetry")
def run(ctx: AnalysisContext) -> List[Diagnostic]:
    from autodist_tpu_torch.telemetry.calibration import (
        DRIFT_THRESHOLD,
        LEG_DRIFT_THRESHOLD,
        STRAGGLER_THRESHOLD,
        leg_drift_reason,
        model_drift_reason,
        straggler_reason,
    )

    tel = getattr(ctx, "telemetry", None)
    if not tel:
        return []
    out: List[Diagnostic] = []
    measured = tel.get("measured_step_time_s")
    predicted = tel.get("predicted_step_time_s")
    if not measured or not predicted:
        out.append(diag(
            "telemetry/no-measurement", Severity.INFO,
            "telemetry provenance has no usable measured/predicted "
            "step-time pair — the model-drift check did not run",
            fix="record a run with telemetry enabled (StepRecords carry "
                "the cost model's prediction) and pass "
                "predicted_vs_measured() output"))
    else:
        threshold = float(tel.get("threshold", DRIFT_THRESHOLD))
        why = model_drift_reason(float(predicted), float(measured),
                                 threshold=threshold)
        if why is not None:
            out.append(diag(
                "telemetry/model-drift", Severity.WARN, why,
                fix="refit ICI_BANDWIDTH/COLLECTIVE_ALPHA via "
                    "telemetry.calibration.fit_constants(records) and "
                    "pass them to estimate_cost/AutoStrategy"))

    # Per-leg-kind drift: the profiler's measured legs vs the
    # leg-priced model — attributes WHICH kind the step drift hides in.
    leg_threshold = float(tel.get("leg_threshold", LEG_DRIFT_THRESHOLD))
    for kind, pair in sorted((tel.get("leg_kinds") or {}).items()):
        why = leg_drift_reason(kind, pair.get("measured_s"),
                               pair.get("predicted_s"),
                               threshold=leg_threshold)
        if why is not None:
            out.append(diag(
                "telemetry/leg-drift", Severity.WARN, why,
                location=kind,
                fix="refit per-kind constants via telemetry.calibration"
                    ".fit_leg_constants(samples) and persist "
                    "calibration.json where AUTODIST_CALIBRATION / "
                    "AUTODIST_TELEMETRY_DIR finds it"))

    # Straggler verdict: per-host medians from the provenance directly
    # or from an aggregate_run() output's hosts mapping.
    per_host = tel.get("per_host_step_time_s")
    if not per_host and isinstance(tel.get("hosts"), dict):
        per_host = {h: s.get("median_s")
                    for h, s in tel["hosts"].items()
                    if isinstance(s, dict)}
    why = straggler_reason(
        per_host, threshold=float(tel.get("straggler_threshold",
                                          STRAGGLER_THRESHOLD)))
    if why is not None:
        out.append(diag(
            "telemetry/straggler", Severity.WARN, why,
            fix="an SPMD step runs at the slowest host's pace — check "
                "that host's input pipeline, thermals, and background "
                "load before touching the strategy"))
    return out
