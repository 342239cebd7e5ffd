"""Sync-coverage pass: every trainable variable has exactly one live
sync rule; nothing is dead, shadowed, or syncing frozen state.

The compiler is forgiving here by design — it prunes dead nodes with a
debug log, lets a later duplicate silently shadow an earlier one, and
backfills untouched trainables with replicate+psum.  Pre-flight is where
forgiveness becomes a bug: a strategy that *meant* to cover a variable
and missed (renamed layer, typo'd pattern) trains that variable with the
default plan and nobody notices.  Rules (docs/analysis.md):

* ``sync/unsynced-trainable`` (ERROR) — a trainable variable with no
  strategy node at all (the compiler would backfill replicate+psum).
* ``sync/missing-synchronizer`` (ERROR) — a node without a synchronizer
  (the compiler raises mid-build).
* ``sync/shadowed-node`` (ERROR) — two nodes for one variable; the
  compiler silently keeps the LAST.
* ``sync/dead-node`` (WARN) — a node naming a variable the program does
  not have (pruned silently).
* ``sync/frozen-var-synced`` (WARN) — a node naming an untrainable
  (frozen) variable: it gets zero updates and no optimizer state, so
  synchronizing it is dead weight.

Overlap-schedule rules (the ``overlap=`` knob, docs/overlap.md; reason
strings shared with the runtime via
``kernel.synchronization.overlap.overlap_drop_reason``, the
``bucket_drop_reason`` pattern):

* ``sync/overlap-unknown`` (ERROR) — ``overlap=`` value outside the
  mode vocabulary (the builders validate it; hand-built plans land
  here).
* ``sync/ring-degenerate`` (ERROR) — ring decomposition
  (``overlap="ring"``/``"full"``) requested while the data (reduction)
  axis has size 1: there is no ring to permute over, and the explicit
  ppermute lowering the request asks for cannot exist.
* ``sync/overlap-fallback`` (WARN) — an overlap schedule was requested
  (or ``"auto"`` had a win available) but this variable cannot join it:
  per-variable fallback path (PowerSGD / partitioned), a cast-based
  compressor blocking pipelined reduction (quantized-ring int8/fp8
  compressors DO pipeline under an explicit ``"pipeline"``/``"full"`` —
  one quantized collective per microbatch slot — and only fall back
  under ``"auto"``), or ``overlap="pipeline"`` with no microbatch loop
  (``accum_steps=1``).
"""
from __future__ import annotations

from typing import List

from autodist_tpu_torch.analysis.analyzer import AnalysisContext, register_pass
from autodist_tpu_torch.analysis.diagnostics import Diagnostic, Severity, diag


def _overlap_rules(ctx: AnalysisContext) -> List[Diagnostic]:
    from autodist_tpu_torch.const import MESH_AXIS_DATA
    from autodist_tpu_torch.kernel.synchronization import overlap as ov
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    diags: List[Diagnostic] = []
    d = ctx.data_axis_size
    accum = int(getattr(ctx.graph_item, "accum_steps", 1) or 1)
    for name, plan in ctx.plans.items():
        if plan.sync_kind != "AllReduce" or plan.synthesized:
            continue
        mode = getattr(plan, "overlap", "auto") or "auto"
        if mode not in ov.OVERLAP_MODES:
            diags.append(diag(
                "sync/overlap-unknown", Severity.ERROR,
                f"overlap={mode!r} is not a schedule mode; expected one "
                f"of {ov.OVERLAP_MODES}",
                var=name, fix="use auto, none, pipeline, ring, or full"))
            continue
        if mode in (ov.OVERLAP_RING, ov.OVERLAP_FULL) and d <= 1:
            diags.append(diag(
                "sync/ring-degenerate", Severity.ERROR,
                f"ring decomposition requested (overlap={mode!r}) but "
                f"the {MESH_AXIS_DATA!r} axis has size {d}: there is no "
                "ring to permute over — the requested lowering cannot "
                "exist on this mesh",
                var=name, location=f"{MESH_AXIS_DATA}={d}",
                fix="grow the data axis past 1 or drop the ring request"))
            continue
        # Routing projection shared with the schedule IR builder
        # (schedule_ir.plan_route) — one rule, no reconstruction here.
        bucketable, explicit = sir.plan_route(
            sir.fact_from_planlite(name, plan))
        why = ov.overlap_drop_reason(
            mode, accum_steps=accum, compressor=plan.compressor,
            bucketable=bucketable, explicit_path=explicit,
            dtype=plan.var.dtype)
        if why is not None:
            diags.append(diag(
                "sync/overlap-fallback", Severity.WARN,
                f"overlap schedule does not apply: {why}",
                var=name,
                fix="see docs/overlap.md for what each mode requires"))
    return diags


@register_pass("sync")
def run(ctx: AnalysisContext) -> List[Diagnostic]:
    diags: List[Diagnostic] = _overlap_rules(ctx)
    gi = ctx.graph_item
    known = {v.name: v for v in gi.info.variables}
    seen: dict = {}

    for node in ctx.strategy.node_config:
        name = node.var_name
        if name in seen:
            diags.append(diag(
                "sync/shadowed-node", Severity.ERROR,
                "duplicate strategy node: the compiler silently keeps the "
                "last one, shadowing the earlier config",
                var=name, fix="keep exactly one node per variable"))
            continue
        seen[name] = node
        var = known.get(name)
        if var is None:
            diags.append(diag(
                "sync/dead-node", Severity.WARN,
                "strategy node names a variable the program does not have "
                "(the compiler prunes it silently)",
                var=name, fix="remove the node or fix the variable name"))
            continue
        if not var.trainable:
            diags.append(diag(
                "sync/frozen-var-synced", Severity.WARN,
                "strategy node targets a frozen (untrainable) variable: "
                "it receives zero updates and no optimizer state, so the "
                "sync rule is dead weight",
                var=name, fix="drop the node or unfreeze the variable"))
            continue
        if node.synchronizer is None:
            diags.append(diag(
                "sync/missing-synchronizer", Severity.ERROR,
                "strategy node has no synchronizer; the compiler raises "
                "ValueError on it",
                var=name, fix="set a PS or AllReduce synchronizer config"))

    for name, var in known.items():
        if var.trainable and name not in seen:
            diags.append(diag(
                "sync/unsynced-trainable", Severity.ERROR,
                "trainable variable has no sync rule; the compiler would "
                "backfill replicate+psum, which may not be what the "
                "strategy intended",
                var=name,
                fix="add a node for it (or an explicit AllReduce default)"))
    return diags
