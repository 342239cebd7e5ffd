"""Static memory-footprint pass: will this plan fit a card's memory?

Port of the JAX package's ``analysis/memory.py``.  Parameter and
optimizer-state bytes come from the catalog and from the captured
optimizer's own ``init`` run on ``meta`` tensors (no memory, dtype-aware:
``ops/opt_state_dtype.cast_opt_state``'s bf16 moments count 2 bytes),
per-device denominators from the plan placements, compressor state from
each compressor's ``init_state`` on a ``meta`` tensor, and activations
from the batch shapes with a remat-aware multiplier.  The per-device
totals equal the JAX package's for the same program.

Rules (docs/analysis.md):

* ``memory/hbm-breakdown`` (INFO) — always emitted: the per-device sum
  ``params + optimizer + gradients + sync-state + activations`` with
  each term listed.
* ``memory/watermark`` (INFO) — when the plan lowers to a schedule IR:
  the **liveness-based watermark** (``analysis/dataflow.py``) — walk
  the legs in a verified topological order, open each transient
  buffer (``grad:``/``red:``/``sync:``) at its first write and close
  it at its last read (donation closes early), stacked on the static
  base ``params + optimizer + activations``.  Reports per-device peak
  bytes, the leg at the peak, and per-microbatch-slot peaks.
* ``memory/watermark-exceeds-hbm`` (ERROR) — the watermark peak
  exceeds the per-device budget (``analyze(budget_bytes=...)``, or the
  resource spec's ``hbm_gb`` yaml key).  This replaces the coarse-sum
  budget comparison whenever a schedule IR exists: the schedule's
  actual liveness (gradient and reduce buffers live simultaneously,
  pipelined slots, donation) is what the device allocates, not the
  flat whole-step sum.
* ``memory/watermark-near-hbm`` (WARN) — the watermark peak exceeds
  90% of the budget.
* ``memory/hbm-over-budget`` (ERROR) — no schedule IR (no synced
  trainables): the coarse sum exceeds the per-device budget.
* ``memory/hbm-near-budget`` (WARN) — no schedule IR: the coarse sum
  exceeds 90% of the budget.
* ``memory/zero1-unused`` (WARN) — the footprint is within 10% of the
  budget (or over it), the mesh has a data axis, and AllReduce plans
  keep replicated optimizer state that ZeRO-1 (``sync=
  "reduce_scatter"`` / the ``Zero1`` builder) could legally shard 1/d —
  emitted with the estimated per-device saving.

Optimizer state under ZeRO-1 plans is counted at ``state_bytes /
data-axis size``: the explicit path carries those slots as flat bucket
shards, one 1/d slice per device (arXiv:2004.13336).

The activation term is a deliberate coarse bound — ``multiplier ×
per-device batch bytes``, with the multiplier shrunk under remat
(``full`` 2×, ``dots``/``dots_no_batch`` 4×, none 8×) — and is skipped
(with a note) when no batch shapes are provided.  The other terms are
exact up to allocator temporaries.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from autodist_tpu_torch.analysis.analyzer import (
    AnalysisContext,
    PlanLite,
    register_pass,
)
from autodist_tpu_torch.analysis.diagnostics import Diagnostic, Severity, diag

#: activation-estimate multipliers over per-device batch bytes, by remat
#: policy (None = no remat).  Coarse by design; documented in
#: docs/analysis.md.
ACTIVATION_MULTIPLIERS = {None: 8.0, "none": 8.0, "full": 2.0,
                          "dots": 4.0, "dots_no_batch": 4.0}

_MiB = float(1 << 20)


def _mib(x: float) -> str:
    return f"{x / _MiB:.1f} MiB"


def _param_and_grad_bytes(ctx: AnalysisContext) -> Dict[str, float]:
    params = grads = 0.0
    for plan in ctx.plans.values():
        b = plan.param_bytes_per_device(ctx.axes)
        params += b
        if plan.var.trainable:
            grads += b
    return {"params": params, "gradients": grads}


def _meta_tree(graph_item):
    """The trainable variables as ``meta`` tensors in the params' tree:
    what the optimizer's ``init`` allocates nothing for."""
    import torch

    from autodist_tpu_torch.graph_item import unflatten

    return unflatten([
        (v.name, torch.empty(tuple(v.shape), device="meta",
                             dtype=getattr(torch, str(v.dtype))))
        for v in graph_item.info.variables if v.trainable])


def _leaf_names(tree, names, prefix=()):
    """``(leaf, variable name or "")`` for every tensor of a state tree:
    a leaf whose path ends in a variable's name and has its shape is that
    variable's slot (the longest such name wins); any other leaf (a step
    count) belongs to no variable."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_names(v, names, prefix + (str(k),))
        return
    if tree is None:
        return
    for i in range(len(prefix)):
        name = "/".join(prefix[i:])
        if name in names and tuple(tree.shape) == tuple(names[name].shape):
            yield tree, name
            return
    yield tree, ""


def _opt_state_bytes(ctx: AnalysisContext) -> Optional[float]:
    """Exact per-device optimizer-state bytes from the captured
    optimizer's ``init`` on ``meta`` tensors (None when no optimizer was
    captured).  Frozen variables carry no state, as in the step."""
    gi = ctx.graph_item
    if gi.optimizer is None or gi.params is None:
        return None
    import numpy as np

    from autodist_tpu_torch.kernel.synchronization.schedule_ir import (
        dtype_itemsize,
    )

    try:
        state = gi.optimizer.init(_meta_tree(gi))
    except Exception:  # pragma: no cover - exotic optimizers
        return None
    names = {v.name: v for v in gi.info.variables if v.trainable}
    total = 0.0
    d = max(ctx.data_axis_size, 1)
    for leaf, name in _leaf_names(state, names):
        size = float(np.prod(tuple(leaf.shape) or (1,)))
        bytes_ = size * dtype_itemsize(leaf.dtype)
        plan = ctx.plans.get(name) if name else None
        if plan is not None:
            logical = float(np.prod(plan.var.shape or (1,)))
            phys = float(np.prod(plan.physical_shape() or (1,)))
            ratio = phys / logical if logical else 1.0
            denom = plan.opt_denominator(ctx.axes)
            if getattr(plan, "zero1", False):
                # Weight-update sharding (sync="reduce_scatter"): the
                # bucketed step carries this var's slots as flat bucket
                # shards, 1/d per device.
                denom = max(denom, 1) * d
            bytes_ = bytes_ * ratio / denom
        total += bytes_
    return total


def _sync_state_bytes(ctx: AnalysisContext) -> float:
    """Compressor (error-feedback / PowerSGD / int8 residual) state per
    device, from each compressor's own ``init_state`` on a ``meta``
    tensor, so the estimate cannot drift from the implementation."""
    import numpy as np
    import torch

    from autodist_tpu_torch.const import MESH_AXIS_DATA
    from autodist_tpu_torch.graph_item import flatten
    from autodist_tpu_torch.kernel.synchronization.compressor import get_compressor
    from autodist_tpu_torch.kernel.synchronization.schedule_ir import (
        dtype_itemsize,
    )

    total = 0.0
    for plan in ctx.plans.values():
        if plan.sync_kind != "AllReduce" or \
                (plan.compressor or "NoneCompressor") == "NoneCompressor":
            continue
        shape = list(plan.var.shape)
        # Supported per-shard state layouts keep the shard shape; every
        # fallback case replicates.
        if (len(plan.placement) == 1 and plan.pad is None):
            (dim, axis_name), = plan.placement.items()
            n = int(ctx.axes.get(axis_name, 1))
            if axis_name != MESH_AXIS_DATA and n > 1 \
                    and shape[dim] % n == 0:
                shape[dim] //= n
        try:
            comp = get_compressor(plan.compressor)
        except ValueError:
            continue  # the precision pass reports unknown compressors
        probe = comp.init_state(torch.empty(
            tuple(shape), device="meta",
            dtype=getattr(torch, str(plan.var.dtype))))
        leaves = [] if probe is None else (
            [x for _, x in flatten(probe)] if isinstance(probe, dict)
            else list(probe) if isinstance(probe, (list, tuple))
            else [probe])
        for leaf in leaves:
            total += float(np.prod(tuple(leaf.shape) or (1,))) \
                * dtype_itemsize(leaf.dtype)
    return total


def _batch_leaves(batch) -> list:
    from autodist_tpu_torch.graph_item import flatten

    if isinstance(batch, dict):
        return [x for _, x in flatten(batch)]
    if isinstance(batch, (list, tuple)):
        return [x for b in batch for x in _batch_leaves(b)]
    return [batch]


def _activation_bytes(ctx: AnalysisContext) -> Optional[float]:
    if ctx.batch is None:
        return None
    import numpy as np

    from autodist_tpu_torch.kernel.synchronization.schedule_ir import (
        dtype_itemsize,
    )

    batch_bytes = 0.0
    for leaf in _batch_leaves(ctx.batch):
        shape = tuple(getattr(leaf, "shape", ()) or ())
        dtype = getattr(leaf, "dtype", None) or np.asarray(leaf).dtype
        batch_bytes += float(np.prod(shape or (1,))) * dtype_itemsize(dtype)
    d = max(ctx.data_axis_size, 1)
    mult = ACTIVATION_MULTIPLIERS.get(
        ctx.graph_item.remat, ACTIVATION_MULTIPLIERS[None])
    return mult * batch_bytes / d


@register_pass("memory")
def run(ctx: AnalysisContext) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    terms = _param_and_grad_bytes(ctx)
    opt = _opt_state_bytes(ctx)
    sync = _sync_state_bytes(ctx)
    act = _activation_bytes(ctx)

    total = terms["params"] + terms["gradients"] + sync
    parts = [f"params {_mib(terms['params'])}",
             f"gradients {_mib(terms['gradients'])}"]
    if opt is None:
        parts.append("optimizer ? (no optimizer captured)")
    else:
        total += opt
        parts.append(f"optimizer {_mib(opt)}")
    parts.append(f"sync-state {_mib(sync)}")
    if act is None:
        parts.append("activations ? (pass batch= for the estimate)")
    else:
        total += act
        remat = ctx.graph_item.remat or "none"
        parts.append(f"activations ~{_mib(act)} (remat={remat})")

    budget = ctx.budget_bytes
    budget_note = f"; budget {_mib(budget)}" if budget else ""
    diags.append(diag(
        "memory/hbm-breakdown", Severity.INFO,
        f"per-device HBM ≈ {_mib(total)} = " + " + ".join(parts)
        + budget_note))

    # Liveness watermark over the schedule IR (analysis/dataflow.py):
    # the static base (params + optimizer + activations) plus the
    # schedule's transient buffers walked leg-by-leg.  Gradients and
    # sync state are NOT in the base — they are the grad:/red:/sync:
    # buffers whose live intervals the simulator opens and closes.
    base = terms["params"] + (opt or 0.0) + (act or 0.0)
    wm = _watermark(ctx, base)
    if wm is not None:
        diags.append(diag(
            "memory/watermark", Severity.INFO,
            f"schedule liveness watermark: {wm.summary()}"
            + budget_note, location=wm.peak_leg,
            data={"params_bytes": terms["params"],
                  "optimizer_bytes": opt or 0.0,
                  "activations_bytes": act or 0.0,
                  "watermark_bytes": wm.peak_bytes}))

    if budget:
        fix_over = ("shard more state (PS/weight-update sharding or "
                    "ZeRO-1 sync='reduce_scatter'), cast optimizer "
                    "moments to bf16 (cast_opt_state), enable remat, or "
                    "shrink the per-device batch")
        fix_near = "leave headroom: shard or remat before scaling up"
        if wm is not None:
            if wm.peak_bytes > budget:
                diags.append(diag(
                    "memory/watermark-exceeds-hbm", Severity.ERROR,
                    f"schedule watermark peak ≈ {_mib(wm.peak_bytes)} at "
                    f"leg {wm.peak_leg!r} exceeds the {_mib(budget)} "
                    "budget (liveness-exact: the device really allocates "
                    "this much while that leg runs)",
                    location=wm.peak_leg, fix=fix_over))
            elif wm.peak_bytes > 0.9 * budget:
                diags.append(diag(
                    "memory/watermark-near-hbm", Severity.WARN,
                    f"schedule watermark peak ≈ {_mib(wm.peak_bytes)} at "
                    f"leg {wm.peak_leg!r} is within 10% of the "
                    f"{_mib(budget)} budget (allocator temporaries may tip it "
                    "over)", location=wm.peak_leg, fix=fix_near))
        elif total > budget:
            diags.append(diag(
                "memory/hbm-over-budget", Severity.ERROR,
                f"per-device footprint ≈ {_mib(total)} exceeds the "
                f"{_mib(budget)} budget", fix=fix_over))
        elif total > 0.9 * budget:
            diags.append(diag(
                "memory/hbm-near-budget", Severity.WARN,
                f"per-device footprint ≈ {_mib(total)} is within 10% of "
                f"the {_mib(budget)} budget (allocator temporaries may tip it "
                "over)", fix=fix_near))
        watermark_total = wm.peak_bytes if wm is not None else total
        if watermark_total > 0.9 * budget and opt is not None:
            diags += _zero1_unused(ctx, opt)
    return diags


def _watermark(ctx: AnalysisContext, base_bytes: float):
    """The liveness watermark of the schedule IR this plan lowers to
    (None when the plan has no synced trainables, the IR cannot be
    built, or its dep graph is unexecutable — the schedule pass owns
    those ERRORs)."""
    try:
        from autodist_tpu_torch.analysis.schedule import ir_for
        ir = ir_for(ctx)
    except Exception:  # pragma: no cover - projection failure
        return None
    if ir is None:
        return None
    from autodist_tpu_torch.analysis import dataflow
    return dataflow.watermark(ir, base_bytes=int(base_bytes))


def _zero1_unused(ctx: AnalysisContext, opt_actual: float
                  ) -> List[Diagnostic]:
    """WARN when the HBM pass is within 10% of budget while AllReduce
    plans keep replicated optimizer state that ZeRO-1 could legally
    shard (eligibility via the runtime's own bucket rule)."""
    from autodist_tpu_torch.kernel.synchronization.bucketing import (
        bucket_drop_reason,
    )

    d = max(ctx.data_axis_size, 1)
    if d <= 1:
        return []
    eligible = [
        p for p in ctx.plans.values()
        if p.sync_kind == "AllReduce" and p.var.trainable
        and not getattr(p, "zero1", False)
        and bucket_drop_reason(sorted(p.placement.items()),
                               p.pad is not None,
                               p.compressor) is None]
    if not eligible:
        return []
    # Exact saving: re-run the optimizer-state accounting with the eligible
    # plans hypothetically sharded (restored afterwards).
    for p in eligible:
        p.zero1 = True
    try:
        opt_sharded = _opt_state_bytes(ctx)
    finally:
        for p in eligible:
            p.zero1 = False
    if opt_sharded is None:
        return []
    saving = opt_actual - opt_sharded
    if saving <= 0:
        return []
    return [diag(
        "memory/zero1-unused", Severity.WARN,
        f"{len(eligible)} AllReduce variable(s) replicate optimizer "
        f"state that ZeRO-1 weight-update sharding could legally cut to "
        f"1/{d} per device (≈{_mib(saving)} saved) while the footprint "
        "is within 10% of the HBM budget",
        fix="use the Zero1 strategy builder or sync='reduce_scatter' "
            "on the AllReduce config")]
