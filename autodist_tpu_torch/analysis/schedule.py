"""Schedule-verifier pass: model-check the sync-schedule IR statically.

Port of the JAX package's ``analysis/schedule.py``.  The passes before
this one lint the *plan projection* (PlanLite); this pass lints the
*program*: it builds the schedule IR (``kernel/synchronization/
schedule_ir.py``) and runs the static verifier over the leg partial
order.  For a :class:`CompiledStrategy` the IR is the one the step it
lowers to builds (:func:`~autodist_tpu_torch.kernel.graph_transformer.
lowered_schedule_ir`), so the analysis IR and the IR the step runs are
one and the same; for a plain Strategy it is ``ir_from_facts`` over the
projection (the JAX package's IR for the same facts).  Rules surface under the
verifier's own ids (docs/schedule-ir.md):

* ``schedule/unknown-dep`` / ``schedule/dep-cycle`` (ERROR) — the leg
  partial order is malformed / unexecutable.
* ``schedule/ring-degenerate`` (ERROR) — ppermute ring hops over an
  axis of size <= 1.
* ``schedule/ring-hop-order`` (ERROR) — a ring hop chain is not the
  consecutive dep-ordered 1..n-1 sequence (swapped/duplicated/missing
  hops deadlock the ppermute).
* ``schedule/quantized-pipelined`` (ERROR) — a quantized bucket's
  collectives violate the pipelining contract: anything other than one
  end-of-step quantized collective, or (int8/fp8 under an explicit
  pipeline request) exactly one quantized collective per microbatch
  slot ``0..accum-1``.
* ``schedule/read-after-donate`` (ERROR) — a donated buffer (any
  namespace: ``sync:``/``param:``/``opt:``) with a read reachable
  after a write by a leg outside its read-modify-write chain.
* ``schedule/race-unordered-write`` / ``schedule/race-read-write``
  (ERROR) — the happens-before race detector
  (``analysis/dataflow.py``): two accesses of one buffer, at least one
  a write, with no ordering path in the dep closure.
* ``schedule/buffer-leak`` (WARN) — a transient buffer written but
  never read nor donated.
* ``schedule/reduction-order-divergence`` (WARN) — a low-precision or
  compressed bucket whose ring order diverges from the GSPMD psum
  tree.
* ``schedule/fused-inconsistent`` (ERROR) — fused-kernel legs
  (docs/kernels.md) that disagree with the IR's ``fused_kernels``
  record.
* ``schedule/fused-fallback`` (WARN) — a fused kernel this program must
  lower unfused (K5 without ``fusable_adam``, a bf16 bucket), with the
  runtime's exact drop-reason string
  (``ops.fused_kernels.fused_drop_reason``).
* ``schedule/elastic-resize`` (INFO) — under elastic provenance
  (``--elastic-from`` / ``preflight_elastic``): the exact leg-level
  delta of the resize (ring hop counts, leg totals), emitted after the
  NEW mesh's schedule verified cleanly.
* ``schedule/fingerprint-drift`` (WARN) — elastic provenance carries a
  recorded ``schedule_fingerprint``, the mesh did NOT change, and this
  program's IR hashes differently: the sync config itself drifted from
  what the checkpoint executed.
* ``schedule/hier-tier-order`` (ERROR) — a hierarchical bucket's
  ICI→DCN→ICI chain is malformed: cross-slice DCN leg missing (silent
  divergence — slices never exchange), out of order against its
  slice-local reduce-scatter/all-gather, duplicated, or hier legs on a
  topology where ``num_slices`` cannot tile the axis.
* ``moe/capacity-overflow`` (WARN) — the IR's MoE routing facts
  predict token drops: ``capacity_factor`` keeps fewer expert slots
  than balanced top-2 demand (the shared pure rule
  ``schedule_ir.moe_capacity_drop_fraction``, also warned by the
  runtime ``moe_ffn`` fallback path).

Cross-stage sequence violations (``schedule/collective-mismatch``) are
deliberately NOT emitted here — the ``collectives`` pass consumes the
same IR and reports them under its established rule id
``collectives/stage-collective-mismatch``.
"""
from __future__ import annotations

from typing import List, Optional

from autodist_tpu_torch.analysis.analyzer import AnalysisContext, register_pass
from autodist_tpu_torch.analysis.diagnostics import Diagnostic, Severity, diag


def ir_for(ctx: AnalysisContext):
    """The schedule IR for this context, built once and cached.

    A :class:`CompiledStrategy` run uses the runtime's own lowered plan
    facts; a plain Strategy run uses the legality pass's PlanLite
    projection — both feed ``schedule_ir.ir_from_facts``, which routes
    through the SAME ``assign_buckets``/``resolve_overlap`` planner the
    runtime executes."""
    cached = getattr(ctx, "schedule_ir", None)
    if cached is not None:
        return cached
    ir = _build_ir(ctx, ctx.axes)
    ctx.schedule_ir = ir
    return ir


def _build_ir(ctx: AnalysisContext, axes) -> Optional[object]:
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    if ctx.compiled is not None and dict(axes) == dict(ctx.axes):
        from autodist_tpu_torch.kernel.graph_transformer import (
            lowered_schedule_ir,
        )
        ir, drops = lowered_schedule_ir(ctx.graph_item, ctx.compiled)
        ctx.fused_drops = drops
        return ir

    facts = []
    guard = False
    for var in ctx.graph_item.info.variables:   # catalog order
        plan = ctx.plans.get(var.name)
        if plan is None or plan.sync_kind is None or not var.trainable:
            continue
        facts.append(sir.fact_from_planlite(var.name, plan))
        guard = guard or bool(getattr(plan, "guard", False))
    if not facts:
        return None
    accum = int(getattr(ctx.graph_item, "accum_steps", 1) or 1)
    active, drops = _resolve_fused(ctx, facts, guard)
    ctx.fused_drops = drops
    # MoE expert a2as: the same expert-flagged catalog projection the
    # runtime lowerings use (schedule_ir.moe_facts_from_vars), so the
    # analysis IR carries the dispatch/combine legs — and the capacity
    # transient — the runtime will execute.
    moe = sir.moe_facts_from_vars(
        ctx.graph_item.info.variables, axes=dict(axes),
        capacity_factor=getattr(ctx, "moe_capacity_factor", None),
        tokens_per_group=getattr(ctx, "moe_tokens_per_group", None))
    num_slices = int(getattr(ctx.resource_spec, "num_slices", 1) or 1)
    return sir.ir_from_facts(facts, axes=dict(axes), accum_steps=accum,
                             guard=guard, fused_kernels=active, moe=moe,
                             num_slices=num_slices)


def _resolve_fused(ctx: AnalysisContext, facts, guard: bool):
    """The SAME fused-kernel resolution the runtime applies
    (``ops.fused_kernels.resolve_fused``: K4 with the guard, K5 on
    ZeRO-1 buckets unless its drop rule says not, K6–K8 on quantized
    ring buckets, with no opt-in) so the analysis IR, and its
    fingerprint, matches what ``make_explicit_step`` lowers, and the
    drop reasons surface here as ``schedule/fused-fallback`` WARNs with
    the runtime's exact strings."""
    from autodist_tpu_torch.kernel.synchronization import quant_ring
    from autodist_tpu_torch.ops import fused_kernels as fk

    optimizer = getattr(ctx.graph_item, "optimizer", None)
    opt_fusable = getattr(optimizer, "fused_spec", None) is not None
    adam_shaped = True
    has_rs = any(f.sync_mode == "reduce_scatter" for f in facts)
    if opt_fusable and has_rs:
        try:
            import torch

            adam_shaped = fk.find_adam_state(
                optimizer.init({"x": torch.zeros(8)})) is not None
        except Exception:  # pragma: no cover - defensive
            adam_shaped = False
    return fk.resolve_fused(
        guard=guard, has_rs=has_rs,
        has_quant_ring=any(
            quant_ring.wire_format_of(f.compressor) is not None
            for f in facts),
        optimizer_fusable=opt_fusable, adam_state_shaped=adam_shaped,
        f32_buckets=all(str(f.dtype) == "float32" for f in facts
                        if f.sync_mode == "reduce_scatter"))


_SEVERITY = {"error": Severity.ERROR, "warn": Severity.WARN}

_FIXES = {
    "schedule/ring-hop-order":
        "restore the consecutive hop order the planner emits "
        "(overlap.ring_reduce_scatter)",
    "schedule/ring-degenerate":
        "grow the axis past 1 or drop the ring decomposition",
    "schedule/quantized-pipelined":
        "a quantized bucket owes ONE quantized collective per step, or "
        "— int8/fp8 under explicit overlap='pipeline'/'full' — exactly "
        "one per microbatch slot; restore one of those shapes",
    "schedule/read-after-donate":
        "undonate the sync state or move the read before the write",
    "schedule/dep-cycle": "break the dependency cycle",
    "schedule/unknown-dep": "fix the dangling dep edge",
    "schedule/reduction-order-divergence":
        "expect >1e-6 explicit-vs-GSPMD divergence for this bucket, or "
        "keep it f32/uncompressed",
    "schedule/fused-inconsistent":
        "rebuild the IR through build_schedule_ir(fused_kernels=...) so "
        "the fused legs and the program record agree",
    "schedule/race-unordered-write":
        "add a dep edge ordering the two writers (the builder chains "
        "every collective a stage issues — a hand-edited program must "
        "preserve that order)",
    "schedule/race-read-write":
        "order the reader against the writer with a dep edge",
    "schedule/buffer-leak":
        "consume the buffer (update/guard/gather) or drop the leg "
        "producing it",
    "moe/capacity-overflow":
        "raise capacity_factor to >= 2.0 (top-2 routing), shrink the "
        "expert count, or accept the predicted token drops knowingly",
    "schedule/hier-tier-order":
        "restore the per-bucket ICI->DCN->ICI chain the hierarchical "
        "builder emits (slice-local reduce-scatter, cross-slice "
        "exchange, slice-local all-gather, dep-ordered)",
}


@register_pass("schedule")
def run(ctx: AnalysisContext) -> List[Diagnostic]:
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    ir = ir_for(ctx)
    if ir is None:
        return []
    diags: List[Diagnostic] = []
    for v in sir.verify(ir):
        if v.rule == sir.RULE_COLLECTIVE_MISMATCH:
            continue   # reported by the collectives pass (same IR)
        diags.append(diag(
            v.rule, _SEVERITY.get(v.severity, Severity.WARN), v.message,
            location=v.location or v.leg, fix=_FIXES.get(v.rule)))
    for kernel, why in getattr(ctx, "fused_drops", ()) or ():
        diags.append(diag(
            "schedule/fused-fallback", Severity.WARN,
            f"requested fused kernel {kernel!r} falls back to the "
            f"unfused lowering: {why}",
            fix="fix the blocking config (fusable_adam, f32 buckets)"))
    diags.extend(_elastic_recheck(ctx, ir))
    return diags


def _elastic_recheck(ctx: AnalysisContext, new_ir) -> List[Diagnostic]:
    """Elastic-resume provenance: re-verify is already done (the pass
    ran on the NEW mesh); here we report the exact leg-level delta the
    resize causes and flag schedule drift on a same-mesh resume."""
    info = getattr(ctx, "elastic", None)
    if not info:
        return []
    diags: List[Diagnostic] = []
    from_axes = {str(k): int(v)
                 for k, v in (info.get("from_axes") or {}).items()}
    axes_changed = any(
        from_axes.get(a, 1) != ctx.axes.get(a, 1)
        for a in set(from_axes) | set(ctx.axes)) if from_axes else False

    if from_axes and axes_changed:
        old_ir = _build_ir(ctx, from_axes)
        if old_ir is not None:
            from autodist_tpu_torch.kernel.synchronization import schedule_ir \
                as sir

            def hops(ir):
                return sum(1 for l in ir.legs
                           if l.kind == sir.LEG_PPERMUTE_HOP)
            diags.append(diag(
                "schedule/elastic-resize", Severity.INFO,
                f"resize re-verified exactly: schedule "
                f"{old_ir.fingerprint()} -> {new_ir.fingerprint()}, "
                f"{len(old_ir.legs)} -> {len(new_ir.legs)} leg(s), "
                f"{hops(old_ir)} -> {hops(new_ir)} ring hop(s); the new "
                "mesh's full leg order passed the schedule verifier",
                location="->".join(
                    f"{k}={v}" for k, v in sorted(from_axes.items()))))

    recorded = info.get("schedule_fingerprint")
    if recorded and not axes_changed \
            and recorded != new_ir.fingerprint():
        diags.append(diag(
            "schedule/fingerprint-drift", Severity.WARN,
            f"checkpoint recorded sync schedule {recorded} but this "
            f"program plans {new_ir.fingerprint()} on the SAME mesh: "
            "the sync config (bucket_bytes / overlap / compressor / "
            "guard) drifted from what the checkpoint executed",
            fix="resume with the writer's sync config, or accept the "
                "schedule change knowingly"))
    return diags
