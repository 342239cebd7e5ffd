"""Precision lint: compressor × dtype × sharding combinations that are
lossy, pointless, or silently fall back.

The compressor layer (``kernel/synchronization/compressor.py``) and the
explicit sync path (``explicit_sync.py``) are deliberately forgiving:
PowerSGD quietly pmean-falls-back on non-matrix gradients, the explicit
path drops a partitioned var to replication when the composition is
undefined, and a bf16 wire on bf16 storage reduces nothing.  Each
fallback is correct-but-surprising; pre-flight is where the surprise
belongs.  The supported-combination matrix is documented in
docs/analysis.md; the fallback logic itself is SHARED with the runtime
(``explicit_sync.partition_drop_reason``) so lint and behavior cannot
drift.

Rules (docs/analysis.md):

* ``precision/unknown-compressor`` (ERROR) — the compressor name is not
  registered; ``get_compressor`` raises at build time.
* ``precision/compressor-integer-dtype`` (ERROR) — a cast-based
  compressor on a non-floating variable: the bf16/int8 wire round-trip
  corrupts integer gradients.
* ``precision/bf16-wire-no-error-feedback`` (WARN) — ``HorovodCompressor``
  (bf16 wire, no error feedback) on f32/f64 variables: quantization
  error accumulates step over step; ``HorovodCompressorEF`` carries the
  residual for the same wire bytes.
* ``precision/compressor-partition-dropped`` (WARN) — a partitioned
  variable whose sharding the explicit path will drop (pad-to-divisible,
  multi-axis, data-axis sharded, or non-grad-shaped compressor state):
  the memory the partitioning was buying silently comes back.
* ``precision/compressor-wire-noop`` (INFO) — wire dtype equals storage
  dtype (bf16 model through a bf16-wire compressor): no bytes saved.
* ``precision/powersgd-rank-fallback`` (INFO) — PowerSGD on a gradient
  of rank ≠ 2 falls back to a plain pmean.
* ``precision/sparse-compressed`` (WARN) — a compressor on a
  sparse-gradient (embedding) variable densifies the scatter-structured
  gradient before compressing it.

Numerics rules (docs/numerics.md; the guard/loss-scale projection is
stamped onto :class:`PlanLite` by the legality pass from the program's
``capture(numerics=...)`` config, via the runtime's own resolution):

* ``numerics/loss-scale-saturates-wire`` (ERROR) — a quantizing
  compressor whose float wire dtype the configured loss scale can
  saturate: a saturated wire value dequantizes to a FINITE number, so
  the post-dequantize guard cannot see the overflow — the one overflow
  class detection-inside-the-sync-path exists for.  Shares
  ``numerics.loss_scale.scale_saturates_wire`` with the runtime's
  build-time check.
* ``numerics/no-loss-scale`` (WARN) — an fp16/bf16 gradient reduced
  without the numerics guard (or with loss scaling resolved off): a
  low-precision overflow/underflow poisons the parameters silently;
  ``capture(numerics=True)`` turns on detection + auto scaling.
"""
from __future__ import annotations

from typing import List

from autodist_tpu_torch.analysis.analyzer import AnalysisContext, register_pass
from autodist_tpu_torch.analysis.diagnostics import Diagnostic, Severity, diag

#: compressors whose wire format is a bf16 downcast of the gradient.
_BF16_WIRE = ("HorovodCompressor", "HorovodCompressorEF")


def _is_float(dtype: str) -> bool:
    import numpy as np
    try:
        return np.issubdtype(np.dtype(dtype), np.floating) or \
            str(dtype) == "bfloat16"
    except TypeError:
        return str(dtype).startswith(("bfloat", "float"))


@register_pass("precision")
def run(ctx: AnalysisContext) -> List[Diagnostic]:
    from autodist_tpu_torch.kernel.synchronization.compressor import _REGISTRY
    from autodist_tpu_torch.kernel.synchronization.explicit_sync import (
        partition_drop_reason,
    )

    diags: List[Diagnostic] = []
    compressed = [p for p in ctx.plans.values()
                  if p.sync_kind == "AllReduce"
                  and (p.compressor or "NoneCompressor") != "NoneCompressor"]
    explicit_path = bool(compressed) or any(
        p.fused for p in ctx.plans.values())

    for plan in compressed:
        name, comp = plan.var.name, plan.compressor
        dtype = str(plan.var.dtype)
        if comp not in _REGISTRY:
            diags.append(diag(
                "precision/unknown-compressor", Severity.ERROR,
                f"compressor {comp!r} is not registered "
                f"(available: {sorted(_REGISTRY)}); the build will raise",
                var=name, fix="pick a registered compressor"))
            continue
        if not _is_float(dtype):
            diags.append(diag(
                "precision/compressor-integer-dtype", Severity.ERROR,
                f"{comp} on a {dtype} variable: the compressed wire "
                "round-trip corrupts non-floating gradients",
                var=name, fix="use NoneCompressor for integer variables"))
            continue
        if comp in _BF16_WIRE and dtype == "bfloat16":
            diags.append(diag(
                "precision/compressor-wire-noop", Severity.INFO,
                f"{comp}'s bf16 wire equals the variable's storage dtype: "
                "the collective moves the same bytes either way",
                var=name, fix="drop the compressor for bf16 variables"))
        elif comp == "HorovodCompressor" and _is_float(dtype):
            diags.append(diag(
                "precision/bf16-wire-no-error-feedback", Severity.WARN,
                f"bf16-wire all-reduce of a {dtype} gradient without f32 "
                "accumulation or error feedback: quantization error "
                "accumulates step over step",
                var=name,
                fix="use HorovodCompressorEF (same wire bytes, residual "
                    "carried) or NoneCompressor"))
        if comp == "PowerSGDCompressor" and len(plan.var.shape) != 2:
            diags.append(diag(
                "precision/powersgd-rank-fallback", Severity.INFO,
                f"PowerSGD only compresses rank-2 gradients; this rank-"
                f"{len(plan.var.shape)} variable falls back to plain pmean",
                var=name))
        if plan.var.sparse:
            diags.append(diag(
                "precision/sparse-compressed", Severity.WARN,
                f"{comp} on a sparse-gradient variable densifies the "
                "scatter-structured gradient before compressing it",
                var=name,
                fix="route sparse variables through PS (Parallax rule)"))

    if explicit_path:
        from autodist_tpu_torch.kernel.synchronization.compressor import (
            get_compressor,
        )
        for plan in ctx.plans.values():
            if not plan.placement or plan.sync_kind is None:
                continue
            comp_name = plan.compressor or "NoneCompressor"
            if comp_name not in _REGISTRY:
                continue
            why = partition_drop_reason(
                sorted(plan.placement.items()), plan.var.shape,
                plan.var.dtype, ctx.axes, plan.pad is not None,
                get_compressor(comp_name))
            if why is not None:
                diags.append(diag(
                    "precision/compressor-partition-dropped", Severity.WARN,
                    "the explicit (compressed/fused) sync path will "
                    f"replicate this partitioned variable ({why}): the "
                    "partitioning's memory win silently disappears",
                    var=plan.var.name,
                    fix="uncompress it, or keep the program on the GSPMD "
                        "path"))

    # -- numerics/* rules (docs/numerics.md) -------------------------------
    from autodist_tpu_torch.numerics.loss_scale import (
        LossScale,
        is_low_precision,
        scale_saturates_wire,
    )
    for plan in ctx.plans.values():
        if plan.sync_kind != "AllReduce":
            continue
        comp = plan.compressor or "NoneCompressor"
        if plan.guard and plan.loss_scale > 0:
            why = scale_saturates_wire(
                LossScale(init=plan.loss_scale, dynamic=False), comp)
            if why is not None:
                diags.append(diag(
                    "numerics/loss-scale-saturates-wire", Severity.ERROR,
                    f"{why}; the saturated wire value dequantizes to a "
                    "FINITE number, so the post-dequantize guard cannot "
                    "see the overflow",
                    var=plan.var.name,
                    fix="lower max_scale/init below the wire dtype's "
                        "range (headroom included) or drop the "
                        "quantizing compressor"))
        if is_low_precision(plan.var.dtype) and (
                not plan.guard or plan.loss_scale <= 0):
            diags.append(diag(
                "numerics/no-loss-scale", Severity.WARN,
                f"{plan.var.dtype} gradients reduce without "
                + ("the numerics guard" if not plan.guard
                   else "loss scaling")
                + ": a low-precision overflow/underflow poisons the "
                  "parameters silently (no detection, no skip)",
                var=plan.var.name,
                fix="capture(numerics=True) — fused non-finite "
                    "detection plus auto loss scaling for low-precision "
                    "programs"))
    return diags
