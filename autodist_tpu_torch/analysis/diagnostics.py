"""Diagnostic records for the static strategy analyzer ("shardlint").

A :class:`Diagnostic` is one finding of one rule: a stable rule id
(``"legality/indivisible-partition"``), a severity, the variable/axis it
anchors to, a human message, and a fix hint.  An :class:`AnalysisReport`
is the ordered list a full pass pipeline produced, with table rendering
for the CLI and ``raise_for_errors`` for the pre-flight hooks.

Severity semantics (docs/analysis.md):

* **ERROR** — the plan is wrong by construction: it will raise inside the
  compiler, produce a program that does not match the strategy's stated
  intent (silently-dropped partitions), deadlock a manual-collective
  schedule, or OOM before the first step.  Pre-flight (``validate=``)
  raises :class:`StrategyValidationError`.
* **WARN** — the plan runs but costs something the user probably did not
  intend (dead strategy nodes, compression fallbacks, precision risks).
  Pre-flight logs each once.
* **INFO** — advisory facts worth surfacing (pad-to-divisible coverage,
  the per-device HBM breakdown).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class Severity(enum.IntEnum):
    """Ordered so ``max()`` over a report gives the worst finding."""

    INFO = 0
    WARN = 1
    ERROR = 2


@dataclass
class Diagnostic:
    """One rule finding."""

    rule: str                      # stable id, "<pass>/<rule-name>"
    severity: Severity
    message: str
    var_name: str = ""             # variable (or "" for whole-plan findings)
    location: str = ""             # axis / dim / stage the finding anchors to
    fix_hint: str = ""
    #: numbers behind the message, for callers that read them (the
    #: memory pass's terms and watermark); not part of the JSON
    data: Dict[str, float] = field(default_factory=dict, compare=False)

    def format(self) -> str:
        where = self.var_name or "<plan>"
        if self.location:
            where += f"[{self.location}]"
        out = f"{self.severity.name:5s} {self.rule:40s} {where}: {self.message}"
        if self.fix_hint:
            out += f"  (fix: {self.fix_hint})"
        return out

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity.name,
                "var_name": self.var_name, "location": self.location,
                "message": self.message, "fix_hint": self.fix_hint}


class StrategyValidationError(ValueError):
    """Raised by pre-flight validation when a plan has ERROR diagnostics.

    Carries the full :class:`AnalysisReport` so callers can render every
    finding, not just the first."""

    def __init__(self, report: "AnalysisReport"):
        self.report = report
        errors = report.errors
        lines = [d.format() for d in errors]
        super().__init__(
            f"strategy failed pre-flight analysis with {len(errors)} "
            "error(s):\n" + "\n".join(lines))


@dataclass
class AnalysisReport:
    """Ordered diagnostics from one analyzer run."""

    diagnostics: List[Diagnostic] = field(default_factory=list)

    def extend(self, diags) -> None:
        self.diagnostics.extend(diags)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.WARN]

    @property
    def infos(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.INFO]

    def has_errors(self) -> bool:
        return any(d.severity == Severity.ERROR for d in self.diagnostics)

    def by_rule(self, rule: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.rule == rule]

    def raise_for_errors(self) -> None:
        if self.has_errors():
            raise StrategyValidationError(self)

    def summary(self) -> str:
        return (f"{len(self.errors)} error(s), {len(self.warnings)} "
                f"warning(s), {len(self.infos)} info")

    def format_table(self, min_severity: Severity = Severity.INFO) -> str:
        """Fixed-width table, worst findings first (stable within a
        severity — pass order is the narrative order)."""
        rows = [d for d in self.diagnostics if d.severity >= min_severity]
        rows.sort(key=lambda d: -int(d.severity))
        if not rows:
            return "analysis: clean (no findings)"
        headers = ("SEV", "RULE", "WHERE", "MESSAGE")
        table = [(d.severity.name, d.rule,
                  (d.var_name or "<plan>")
                  + (f"[{d.location}]" if d.location else ""),
                  d.message + (f"  fix: {d.fix_hint}" if d.fix_hint else ""))
                 for d in rows]
        widths = [max(len(headers[i]), *(len(r[i]) for r in table))
                  for i in range(3)]
        lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))
                 + "  " + headers[3]]
        lines.append("  ".join("-" * w for w in widths) + "  " + "-" * 7)
        for r in table:
            lines.append("  ".join(r[i].ljust(widths[i]) for i in range(3))
                         + "  " + r[3])
        lines.append(self.summary())
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"diagnostics": [d.to_dict() for d in self.diagnostics],
                "errors": len(self.errors), "warnings": len(self.warnings)}


def diag(rule: str, severity: Severity, message: str, *, var: str = "",
         location: str = "", fix: str = "",
         data: Optional[Dict[str, float]] = None) -> Diagnostic:
    """Terse constructor used by the passes."""
    return Diagnostic(rule=rule, severity=severity, message=message,
                      var_name=var, location=location, fix_hint=fix,
                      data=dict(data or {}))
