"""Search support pass surface: legality pruning hooks + explain report.

The strategy search (:mod:`autodist_tpu_torch.strategy.search`) prunes every
candidate through the analyzer's pure ``legality``/``sync`` rules BEFORE
paying for IR construction and pricing — no mesh, no tracing, one
projection per candidate.  This module owns that hook
(:func:`project_plans` / :func:`facts_for_candidate`) plus the human
surface: :func:`search_report` runs the beam search and packages the
top-K candidates with their per-leg-kind cost breakdown and the exact
legality rule that killed each pruned branch (the JAX package's CLI
prints it, and so does the port's, ``--search-report``).
"""
from __future__ import annotations

from dataclasses import replace as _replace
from typing import Dict, List, Optional, Tuple

from autodist_tpu_torch.graph_item import GraphItem


def project_plans(strategy, graph_item: GraphItem,
                  axes: Dict[str, int], *,
                  resource_spec=None) -> Tuple[dict, Optional[str]]:
    """Run the analyzer's pure legality+sync passes over one candidate.

    Returns ``(plans, prune_reason)``: the PlanLite projection keyed by
    variable name, and — when any ERROR rule fired — a
    ``"rule: message"`` string naming the first one (the search's
    prune verdict; the explain surface prints it verbatim)."""
    from autodist_tpu_torch.analysis.analyzer import (
        AnalysisContext,
        PASS_REGISTRY,
        _load_passes,
    )

    # One context, two passes — analyze() would work too, but building
    # the context directly keeps the projection (ctx.plans) in hand for
    # fact construction without a second lowering.
    _load_passes()
    ctx = AnalysisContext(strategy=strategy, graph_item=graph_item,
                          axes={str(k): int(v) for k, v in axes.items()},
                          resource_spec=resource_spec)
    diags = list(PASS_REGISTRY["legality"](ctx))
    diags += PASS_REGISTRY["sync"](ctx)
    from autodist_tpu_torch.analysis.diagnostics import Severity
    for d in diags:
        if d.severity == Severity.ERROR:
            return ctx.plans, f"{d.rule}: {d.message}"
    return ctx.plans, None


def facts_for_candidate(strategy, graph_item: GraphItem,
                        axes: Dict[str, int], *,
                        sparse_rows_hint: int = 4096,
                        resource_spec=None):
    """The search's prune+project step for one candidate strategy.

    Returns ``(facts, priced_facts, guard, prune_reason)``:

    * ``facts`` — canonical :class:`PlanFact` list in catalog order
      (the IR/fingerprint substrate);
    * ``priced_facts`` — the pricing shadow: sparse PS variables shrink
      to their touched rows (``min(sparse_rows_hint, vocab)`` — the
      Parallax rule the plan-level ``estimate_cost`` already applies),
      so the leg-priced estimate sees the honest wire; identical object
      to ``facts`` when nothing shrinks;
    * ``guard`` — whether the numerics guard is active on any plan;
    * ``prune_reason`` — the legality/sync ERROR that kills the branch,
      or None."""
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    plans, prune = project_plans(strategy, graph_item, axes,
                                 resource_spec=resource_spec)
    if prune is not None:
        return [], [], False, prune
    facts, priced, guard = [], [], False
    shrunk = False
    for var in graph_item.info.variables:       # catalog order
        plan = plans.get(var.name)
        if plan is None or plan.sync_kind is None or not var.trainable:
            continue
        fact = sir.fact_from_planlite(var.name, plan)
        facts.append(fact)
        guard = guard or bool(getattr(plan, "guard", False))
        if var.sparse and plan.sync_kind == "PS" and fact.shape:
            rows = min(int(sparse_rows_hint), int(fact.shape[0] or 1))
            priced.append(_replace(
                fact, shape=(rows,) + tuple(fact.shape[1:])))
            shrunk = True
        else:
            priced.append(fact)
    if not facts:
        return [], [], False, ("sync/empty-plan: no trainable variable "
                               "lowers to a sync collective")
    return facts, (priced if shrunk else facts), guard, None


def search_report(graph_item: GraphItem, resource_spec, *,
                  axes: Optional[Dict[str, int]] = None,
                  top_k: int = 5, space=None, constants=None) -> dict:
    """Run the beam search and package the explain report: top-K
    candidates with per-leg-kind cost breakdown, every pruned branch
    with the rule that killed it, and the search provenance."""
    from autodist_tpu_torch.strategy.search import beam_search, resolve_axes

    if axes is None:
        axes = resolve_axes(graph_item, resource_spec)
    result = beam_search(graph_item, resource_spec, axes=axes,
                         space=space, constants=constants)
    report = result.to_dict(top_k)
    report["axes"] = dict(axes)
    return report


def format_search_report(report: dict) -> str:
    """Human rendering of :func:`search_report` (the CLI table)."""
    lines: List[str] = []
    axes = ",".join(f"{k}={v}" for k, v in sorted(
        (report.get("axes") or {}).items()))
    lines.append(
        f"strategy search: {report['n_evals']} candidate(s) priced, "
        f"{report['n_pruned']} pruned, {report['rounds']} round(s), "
        f"{report['wall_time_s']:.2f} s on mesh [{axes}]"
        f"{' (calibrated)' if report.get('calibrated') else ''}")
    best = report.get("best")
    if best is None:
        lines.append("no candidate survived legality pruning")
        return "\n".join(lines)
    lines.append("")
    lines.append("top candidates (cheapest first):")
    for i, c in enumerate(report.get("top") or []):
        marker = "*" if c["fingerprint"] == best["fingerprint"] else " "
        lines.append(
            f" {marker} #{i + 1} {c['name']}  cost {c['cost_ms']:.4f} ms  "
            f"exposed {c['exposed_wire_bytes'] / 1e6:.2f} MB  "
            f"{c['num_collectives']} collectives  [{c['fingerprint']}]")
        per_kind = c.get("per_kind_ms") or {}
        if per_kind:
            breakdown = "  ".join(
                f"{k}={v:.4f}ms" for k, v in sorted(
                    per_kind.items(), key=lambda kv: -kv[1]))
            lines.append(f"      per-leg-kind: {breakdown}")
    pruned = report.get("pruned") or []
    if pruned:
        lines.append("")
        lines.append(f"pruned branches ({len(pruned)}):")
        for c in pruned:
            lines.append(f"   {c['name']}: {c.get('pruned_by')}")
    return "\n".join(lines)
