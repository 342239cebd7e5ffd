"""autodist_tpu_torch.analysis — static strategy/sharding analysis.

Port of the JAX package's ``analysis`` package: a pre-flight pass
pipeline over ``(Strategy | CompiledStrategy, GraphItem, mesh axes,
resource spec)`` that rejects bad distribution plans in milliseconds with
rule-tagged diagnostics, before any step runs.  The passes: sharding
legality, sync coverage, per-device memory, collective-schedule
consistency, the static schedule verifier (over the schedule IR the
bucketed step lowers), precision, and the provenance-gated elastic,
telemetry and resilience passes.  See docs/analysis.md for every rule id.

Entry points:

* :func:`analyze` — run the pipeline, get an :class:`AnalysisReport`.
* :func:`preflight` / :func:`preflight_session` — the ``validate=``
  hook bodies used by ``AutoDist.create_distributed_session`` and
  ``fit``: raise :class:`StrategyValidationError` on ERROR diagnostics,
  log WARNs once.

The analyzer's CLI is ``python -m autodist_tpu_torch.analysis``
(``__main__.py``), and its ``--simulate`` sweep is :mod:`autodist_tpu_torch.
analysis.simulate`.
"""
from autodist_tpu_torch.analysis.analyzer import (
    AnalysisContext,
    PASS_ORDER,
    PlanLite,
    analyze,
    log_report,
    preflight,
    preflight_session,
)
from autodist_tpu_torch.analysis.diagnostics import (
    AnalysisReport,
    Diagnostic,
    Severity,
    StrategyValidationError,
)

__all__ = [
    "AnalysisContext", "AnalysisReport", "Diagnostic", "PASS_ORDER",
    "PlanLite", "Severity", "StrategyValidationError", "analyze",
    "log_report", "preflight", "preflight_session",
]
