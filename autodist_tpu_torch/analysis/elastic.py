"""Elastic-resume pass: validate resuming a checkpoint on a resized mesh.

Port of the JAX package's ``analysis/elastic.py``.  Runs only when the
analyzer is given elastic provenance — ``analyze(..., elastic=
{"from_axes": {...}[, "buckets": [...]]})`` from
:func:`autodist_tpu_torch.resilience.elastic.preflight_elastic`, or the
CLI's ``--elastic-from data=8`` — and answers "can the plan written at
the OLD axes resume at the NEW ones, and what does it cost?"  The
companion re-checks come from the normal pipeline running against the
NEW mesh: ``sync/ring-degenerate`` re-fires if the shrunken data axis
can no longer host a ring schedule, and the memory pass re-estimates
HBM with optimizer state at 1/M.

The buckets are planned by the planner the step executes: for a
compiled strategy (what ``preflight_elastic`` passes), the explicit
step's own plan (``explicit_sync.plan_step_buckets``, its reduce-scatter
buckets: PS-synced and stored variables included, which is the layout
the port's checkpoints record); for a bare Strategy (the CLI), the JAX
package's rule over the ZeRO-1 plans, so the CLI's report equals the
JAX package's.

Rules:

* ``elastic/axis-resize`` (INFO) — the reshard plan: how many ZeRO-1
  buckets reslice, the old→new padded lengths, and the per-device flat
  optimizer-shard growth factor.  Emitted whenever the data axis
  changes; the reshard itself is always exact (only zero padding
  changes — ``resilience/elastic.py``).
* ``elastic/bucket-mismatch`` (ERROR) — the checkpoint's recorded
  bucket layout (``"buckets"``) does not match what this program plans:
  membership/dtype/element-count drift (changed ``bucket_bytes`` or
  variable catalog) makes the flat shards unrecoverable by slicing.
* ``elastic/hbm-grows`` (WARN) — the data axis SHRANK under ZeRO-1
  plans: every surviving device now holds a larger (1/M > 1/N) slice of
  the flat optimizer state.
* ``elastic/sync-state-reset`` (WARN) — compressor state (error-feedback
  residuals etc.) exists and an axis changed size: per-rank sync state
  cannot be resharded and reinitializes, so resume is approximate ON
  THE COMPRESSOR PATH (params/opt stay exact).
"""
from __future__ import annotations

from typing import List

from autodist_tpu_torch.analysis.analyzer import AnalysisContext, register_pass
from autodist_tpu_torch.analysis.diagnostics import (Diagnostic, Severity,
                                                    diag)

_MiB = float(1 << 20)


def _plan_buckets(ctx: AnalysisContext, d: int):
    """Re-plan the ZeRO-1 buckets at data-axis size ``d`` using the
    SAME pure planner the runtime executes, so this pass can never drift
    from the lowering (see the module docstring)."""
    from autodist_tpu_torch.kernel.synchronization import bucketing
    from autodist_tpu_torch.kernel.synchronization.schedule_ir import \
        dtype_str

    var_plans = getattr(ctx.compiled, "var_plans", None)
    if var_plans is not None and getattr(ctx.graph_item, "info", None):
        from autodist_tpu_torch.kernel.synchronization.explicit_sync import \
            plan_step_buckets

        return [b for b in plan_step_buckets(ctx.graph_item, ctx.compiled,
                                             max(d, 1))
                if b.mode == bucketing.MODE_REDUCE_SCATTER]

    entries = []
    cap = 0
    for name, plan in ctx.plans.items():
        if not getattr(plan, "zero1", False):
            continue
        entries.append((name, tuple(plan.var.shape),
                        dtype_str(plan.var.dtype),
                        plan.compressor or "NoneCompressor",
                        int(plan.group), bucketing.MODE_REDUCE_SCATTER))
        cap = max(cap, int(getattr(plan, "bucket_bytes", 0) or 0))
    if not entries:
        return []
    return bucketing.assign_buckets(
        entries, bucket_bytes=cap or bucketing.DEFAULT_BUCKET_BYTES,
        shard_divisor=max(d, 1))


@register_pass("elastic")
def run(ctx: AnalysisContext) -> List[Diagnostic]:
    info = getattr(ctx, "elastic", None)
    if not info:
        return []
    from autodist_tpu_torch.kernel.synchronization.schedule_ir import \
        dtype_itemsize

    diags: List[Diagnostic] = []
    from_axes = {str(k): int(v)
                 for k, v in (info.get("from_axes") or {}).items()}
    old_d = max(from_axes.get("data", 1), 1)
    new_d = max(ctx.data_axis_size, 1)

    old_buckets = _plan_buckets(ctx, old_d)
    new_buckets = _plan_buckets(ctx, new_d)

    recorded = info.get("buckets")
    if recorded:
        from autodist_tpu_torch.resilience.elastic import layout_mismatch

        why = layout_mismatch(recorded, new_buckets)
        if why is not None:
            diags.append(diag(
                "elastic/bucket-mismatch", Severity.ERROR,
                f"checkpoint bucket layout cannot map onto this plan: "
                f"{why}",
                fix="resume with the same bucket_bytes and variable "
                    "catalog the checkpoint was written with (bucket "
                    "membership is axis-independent, so only config "
                    "drift causes this)"))

    changed_axes = {a for a in set(from_axes) | set(ctx.axes)
                    if from_axes.get(a, 1) != ctx.axes.get(a, 1)}
    if old_d != new_d and old_buckets:
        new_by_key = {b.key: b for b in new_buckets}
        moved = sum(b.nbytes for b in old_buckets)
        resized = sum(1 for b in old_buckets
                      if b.key in new_by_key
                      and new_by_key[b.key].padded_total != b.padded_total)
        # per-device flat shard bytes: sum(padded/d) * itemsize
        def shard_bytes(buckets, d):
            return sum(b.padded_total // max(d, 1)
                       * dtype_itemsize(b.dtype) for b in buckets)
        old_pd = shard_bytes(old_buckets, old_d)
        new_pd = shard_bytes(new_buckets, new_d)
        diags.append(diag(
            "elastic/axis-resize", Severity.INFO,
            f"resuming data={old_d} -> data={new_d}: {len(old_buckets)} "
            f"ZeRO-1 bucket(s) ({moved / _MiB:.1f} MiB of flat optimizer "
            f"state) reslice 1/{new_d}, {resized} re-padded; per-device "
            f"flat shard {old_pd / _MiB:.2f} -> {new_pd / _MiB:.2f} MiB "
            f"per state leaf — exact (only zero padding changes)",
            location=f"data={old_d}->{new_d}"))
        if new_d < old_d:
            diags.append(diag(
                "elastic/hbm-grows", Severity.WARN,
                f"the data axis shrank {old_d} -> {new_d}: each surviving "
                f"device holds a {old_d / new_d:.2g}x larger slice of the "
                "ZeRO-1 optimizer state (see memory/hbm-breakdown on the "
                "new mesh)",
                fix="confirm the per-device HBM budget on the shrunken "
                    "mesh before resuming"))
    elif old_d != new_d:
        diags.append(diag(
            "elastic/axis-resize", Severity.INFO,
            f"resuming data={old_d} -> data={new_d}: no ZeRO-1 flat "
            "state; params and tree optimizer state reshard natively",
            location=f"data={old_d}->{new_d}"))

    if changed_axes and any(
            (p.compressor or "NoneCompressor") != "NoneCompressor"
            for p in ctx.plans.values()):
        diags.append(diag(
            "elastic/sync-state-reset", Severity.WARN,
            f"mesh axes {sorted(changed_axes)} changed size and compressor "
            "state exists: per-device residuals reinitialize on resume — "
            "exact on params/optimizer, approximate on the compressed "
            "gradient stream for the first steps",
            fix="checkpoint at a step where residual magnitude is small, "
                "or accept the transient"))
    return diags
