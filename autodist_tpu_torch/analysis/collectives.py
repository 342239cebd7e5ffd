"""Collective-schedule consistency pass: a static deadlock lint for
pipeline and MoE plans.

SPMD programs cannot deadlock on strategy choices — every device runs
the same program.  The hazard lives exactly where this framework leaves
SPMD: the ``shard_map``-manual pipeline schedules (``parallel/pipeline``,
``pipeline_1f1b``) and hand-laid per-stage parameter groups, where each
stage's devices issue their own collective sequence.  If stage 0's
variables all-reduce through a compressor while stage 1's do a plain
psum, or one stage fuses its group into a single concat-and-pmean while
another issues per-variable reductions, the stages disagree on the
*number and order* of collectives — the classic SPMD hang.

The pass used to reconstruct per-stage collective sequences from a
lossy plan tuple; it now consumes the **sync-schedule IR**
(``kernel/synchronization/schedule_ir.py``, shared with the runtime
lowerings and the ``schedule`` verifier pass), whose legs carry the
bucketed collective schedule the runtime will actually issue — with
microbatch slots, ring hop chains, and per-bucket algorithms — so the
cross-stage comparison is exact instead of heuristic.  Stage identity
comes from two sources:

* **stacked** parameters (``pipeline_vars``/``expert_vars``): one
  variable spans all stages, so its collective is uniform by
  construction — only the stack shapes are checked for agreement;
* **named** per-stage parameter groups — a path component matching
  ``stage<k>`` / ``expert<k>`` (e.g. ``stage0/attn/kernel``) — the
  layout of hand-built non-stacked pipelines, where the lint has real
  teeth.  Stage-tagged IR legs (per-stage buckets and per-variable
  fallbacks) must form identical ordered sequences per microbatch
  slot; a bucket spanning every stage is uniform by construction.

Rules (docs/analysis.md):

* ``collectives/stage-collective-mismatch`` (ERROR) — per-stage groups
  issue different ordered collective sequences (length, entry, or
  microbatch slot) — the IR-level ``schedule/collective-mismatch``
  check surfaced under this pass's established rule id.
* ``collectives/stage-stack-heterogeneous`` (WARN) — stacked pipeline
  (or expert) variables disagree on the stage/expert stack size.
* ``collectives/unused-parallel-axis`` (WARN) — the mesh carries a
  pipe/expert axis of size > 1 but no variable uses it.
* ``collectives/staleness-mixed`` (WARN) — some-but-not-all PS plans use
  bounded staleness: stale and fresh gradients interleave on one update
  schedule (legal, rarely intended).
"""
from __future__ import annotations

import re
from typing import List

from autodist_tpu_torch.analysis.analyzer import (
    AnalysisContext,
    register_pass,
)
from autodist_tpu_torch.analysis.diagnostics import Diagnostic, Severity, diag
from autodist_tpu_torch.const import MESH_AXIS_EXPERT, MESH_AXIS_PIPE


def _check_named_groups(ctx: AnalysisContext) -> List[Diagnostic]:
    """Exact cross-stage deadlock check over the shared schedule IR:
    the verifier's ``schedule/collective-mismatch`` violations surface
    here under this pass's established rule id (the IR is built once
    and cached on the context — see ``analysis.schedule.ir_for``)."""
    from autodist_tpu_torch.analysis.schedule import ir_for
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    ir = ir_for(ctx)
    if ir is None:
        return []
    diags: List[Diagnostic] = []
    for v in sir.verify(ir):
        if v.rule != sir.RULE_COLLECTIVE_MISMATCH:
            continue
        kind = re.match(r"[a-z]+", v.location or "stage").group(0)
        diags.append(diag(
            "collectives/stage-collective-mismatch", Severity.ERROR,
            v.message, location=v.location,
            fix="use one synchronizer/compressor/grouping/overlap "
                f"config across all {kind}s"))
    return diags


def _check_stacked(ctx: AnalysisContext) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for flag, axis_name, dim_of in (
            ("pipeline", MESH_AXIS_PIPE, lambda v: 0),
            ("expert", MESH_AXIS_EXPERT,
             lambda v: 1 if v.pipeline else 0)):
        stacked = [p.var for p in ctx.plans.values()
                   if getattr(p.var, flag) and p.var.shape]
        sizes = {v.shape[dim_of(v)] for v in stacked
                 if len(v.shape) > dim_of(v)}
        if len(sizes) > 1:
            diags.append(diag(
                "collectives/stage-stack-heterogeneous", Severity.WARN,
                f"{flag}-stacked variables disagree on the stack size "
                f"({sorted(sizes)}): only interleaved virtual stages "
                "legitimately multiply it — check the stacking",
                location=axis_name,
                fix=f"stack every {flag} variable to the same leading "
                    "size (x virtual-stage factor)"))
        size = int(ctx.axes.get(axis_name, 1))
        if size > 1 and not stacked and axis_name not in {
                a for p in ctx.plans.values()
                for a in p.placement.values()}:
            diags.append(diag(
                "collectives/unused-parallel-axis", Severity.WARN,
                f"mesh carries a {axis_name!r} axis of size {size} but no "
                f"variable is {flag}-stacked or sharded over it: those "
                "devices replicate all work",
                location=axis_name,
                fix=f"flag the stacked variables via {flag}_vars=, or "
                    f"drop the {axis_name!r} axis"))
    return diags


def _check_staleness(ctx: AnalysisContext) -> List[Diagnostic]:
    ps = [p for p in ctx.plans.values() if p.sync_kind == "PS"]
    stale = [p for p in ps if p.staleness > 0]
    if stale and len(stale) != len(ps):
        return [diag(
            "collectives/staleness-mixed", Severity.WARN,
            f"{len(stale)} of {len(ps)} PS plans use bounded staleness: "
            "stale and fresh gradients interleave on one update schedule",
            var=stale[0].var.name,
            fix="use one staleness bound for all PS variables")]
    return []


@register_pass("collectives")
def run(ctx: AnalysisContext) -> List[Diagnostic]:
    diags = _check_named_groups(ctx)
    diags += _check_stacked(ctx)
    diags += _check_staleness(ctx)
    return diags
