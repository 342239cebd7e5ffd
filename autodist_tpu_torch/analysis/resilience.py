"""Resilience pass: does the checkpoint cadence bound work loss?

Provenance-gated like the elastic and telemetry passes: feed
``analyze(..., resilience={...})`` the run's recovery configuration —
most usefully :func:`autodist_tpu_torch.telemetry.goodput.checkpoint_cadence`
over a recorded run, or the planned config before launch — and the pass
checks the recovery exposure (checkpoint interval × calibrated step
time, capped by the RAM snapshot tier when one is configured) against a
recovery-loss budget.  Inert without provenance.

Rules (docs/resilience.md, docs/observability.md):

* ``resilience/recovery-gap`` (WARN) — the cheapest configured tier
  leaves more than ``recovery_budget_s`` (default
  :data:`~autodist_tpu_torch.telemetry.goodput.RECOVERY_BUDGET_S`) of work
  exposed to a single failure.  Shared pure rule
  :func:`~autodist_tpu_torch.telemetry.goodput.recovery_gap_reason` — the
  telemetry CLI's goodput section prints the identical string.
* ``resilience/no-measurement`` (INFO) — resilience provenance was
  passed but holds no usable interval/step-time pair; the gap check
  could not run.

Provenance dict keys: ``checkpoint_interval_steps`` (steps between
persistent saves), ``step_time_s`` (measured or leg-calibrated),
optional ``snapshot_every`` (RAM tier cadence, steps) and
``recovery_budget_s`` (budget override).
"""
from __future__ import annotations

from typing import List

from autodist_tpu_torch.analysis.analyzer import AnalysisContext, register_pass
from autodist_tpu_torch.analysis.diagnostics import Diagnostic, Severity, diag


@register_pass("resilience")
def run(ctx: AnalysisContext) -> List[Diagnostic]:
    from autodist_tpu_torch.telemetry.goodput import (
        RECOVERY_BUDGET_S,
        recovery_gap_reason,
    )

    res = getattr(ctx, "resilience", None)
    if not res:
        return []
    out: List[Diagnostic] = []
    interval = res.get("checkpoint_interval_steps")
    step_time = res.get("step_time_s")
    if not interval or not step_time:
        out.append(diag(
            "resilience/no-measurement", Severity.INFO,
            "resilience provenance has no usable checkpoint-interval/"
            "step-time pair — the recovery-gap check did not run",
            fix="pass checkpoint_interval_steps and step_time_s (e.g. "
                "telemetry.goodput.checkpoint_cadence over a recorded "
                "run, or the planned cadence with a leg-calibrated "
                "step-time estimate)"))
        return out
    why = recovery_gap_reason(
        float(interval), float(step_time),
        budget_s=float(res.get("recovery_budget_s", RECOVERY_BUDGET_S)),
        snapshot_every=res.get("snapshot_every"))
    if why is not None:
        out.append(diag(
            "resilience/recovery-gap", Severity.WARN, why,
            fix="checkpoint more often, or enable the RAM snapshot "
                "tier (fit(snapshot_every=...) / "
                "AUTODIST_SNAPSHOT_EVERY) so a failure loses at most "
                "snapshot_every steps (docs/resilience.md)"))
    return out
