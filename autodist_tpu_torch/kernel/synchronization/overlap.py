"""Bucket-collective schedules of the explicit bucketed step.

Port of the JAX package's ``kernel/synchronization/overlap.py:72-436``
for what the port runs at ``accum_steps == 1``:

* the ``overlap=`` vocabulary and :func:`resolve_overlap`, which turns
  the plans' values into one :class:`OverlapPlan` (an explicit ``"none"``
  wins, then the first explicit mode, else ``"auto"``);
* :func:`reduce_alg`, each bucket's lowering label, the rule of the JAX
  package's schedule IR (``schedule_ir.py:1199-1210``; the IR itself is
  ROADMAP P8) line for line: ``"ring"`` at :data:`RING_THRESHOLD_BYTES`
  and above when the plan rings, ``"one_shot"`` for small all-reduce
  buckets under explicit ``"ring"``/``"full"``, else ``"fused"`` (the
  backend's collective).  A quantized bucket reduces as its label says
  (``quant_ring.quant_bucket_reduce``);
* :func:`bucket_reduce_fn`, the reduction of an uncompressed bucket: the
  backend's ``all_reduce`` / ``reduce_scatter`` whatever its label.  The
  JAX package decomposes a linear ring bucket into ``n - 1`` ``ppermute``
  hops so its schedule can overlap them with backward; the port's step
  is phase-serial, so that decomposition would only add calls (ROADMAP:
  the linear ring lowering waits for a measured NCCL run);
* the ZeRO-1 parameter gathers in :func:`gather_schedule` order (reverse
  bucket order under prefetch), each one backend ``all_gather``.

The accumulation pipeline (``"pipeline"``, and ``"full"`` with
``accum_steps > 1``) and the hierarchical tier are not ported; the
lowering refuses them (``kernel/graph_transformer.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from autodist_tpu_torch.kernel.synchronization import collectives as coll
from autodist_tpu_torch.kernel.synchronization import quant_ring
from autodist_tpu_torch.kernel.synchronization.bucketing import (  # noqa: F401
    MODE_REDUCE_SCATTER, OVERLAP_AUTO, OVERLAP_FULL, OVERLAP_MODES,
    OVERLAP_NONE, OVERLAP_PIPELINE, OVERLAP_RING, Bucket)

#: buckets at or above this byte size take the ring lowering
RING_THRESHOLD_BYTES = 256 << 10

#: the lowerings of a bucket's reduction (the schedule IR's names)
ALG_RING = "ring"            # explicit ring hop chain
ALG_ONE_SHOT = "one_shot"    # one all-gather and a local reduction
ALG_FUSED = "fused"          # the backend's own collective

_LINEAR_COMPRESSORS = ("", "NoneCompressor")


def is_linear_compressor(compressor: str) -> bool:
    return (compressor or "NoneCompressor") in _LINEAR_COMPRESSORS


def overlap_drop_reason(overlap: str, *, accum_steps: int, compressor: str,
                        bucketable: bool, explicit_path: bool,
                        dtype: str = "float32") -> Optional[str]:
    """Why overlap scheduling does not apply to one variable, or None (the
    JAX package's rule and strings)."""
    if overlap not in OVERLAP_MODES:
        return (f"unknown overlap mode {overlap!r}; expected one of "
                f"{OVERLAP_MODES}")
    if overlap == OVERLAP_NONE:
        return None
    if not explicit_path:
        if overlap == OVERLAP_AUTO:
            return None
        return ("GSPMD path (no explicit bucketing): set bucket_bytes, a "
                "compressor, or sync='reduce_scatter' to route the "
                "program through the schedulable shard_map path")
    if not bucketable:
        return ("per-variable fallback path (partitioned or "
                "non-bucketable compressor, e.g. PowerSGD): its "
                "collective is issued once at end of step and cannot "
                "join the overlapped bucket schedule")
    wants_pipeline = overlap in (OVERLAP_PIPELINE, OVERLAP_FULL) \
        or (overlap == OVERLAP_AUTO and accum_steps > 1)
    if wants_pipeline and not is_linear_compressor(compressor):
        if quant_ring.is_quant_ring_compressor(compressor):
            if overlap == OVERLAP_AUTO:
                return (f"{compressor} adds one quantization rounding "
                        "per microbatch when pipelined; auto keeps the "
                        "single end-of-step quantized collective (set "
                        "overlap='pipeline' or 'full' to pipeline one "
                        "quantized collective per microbatch slot)")
        else:
            return (f"{compressor} quantizes once per bucket per step; "
                    "per-microbatch pipelined reduction would change the "
                    "wire numerics, so the bucket keeps the end-of-step "
                    "compressed collective")
    if (overlap == OVERLAP_AUTO and wants_pipeline
            and np.dtype(dtype) != np.float32):
        return (f"{np.dtype(dtype).name} bucket: per-microbatch reduction "
                "adds a low-precision rounding per microbatch; auto keeps "
                "the end-of-step collective (set overlap='pipeline' or "
                "'full' to force pipelining)")
    if overlap == OVERLAP_PIPELINE and accum_steps <= 1:
        return ("accum_steps=1: there is no microbatch loop to "
                "pipeline (single-microbatch degenerate case)")
    return None


def pipeline_eligible(bucket: Bucket, mode: str, accum_steps: int) -> bool:
    """Does this bucket join the accumulation pipeline under ``mode``?"""
    if accum_steps <= 1:
        return False
    return overlap_drop_reason(
        mode, accum_steps=accum_steps, compressor=bucket.compressor,
        bucketable=True, explicit_path=True, dtype=bucket.dtype) is None \
        and mode in (OVERLAP_AUTO, OVERLAP_PIPELINE, OVERLAP_FULL)


@dataclass(frozen=True)
class OverlapPlan:
    """The resolved step-level schedule."""

    mode: str                      # the winning knob value
    pipeline: bool                 # accumulation pipelining wanted
    ring: bool                     # ring-decompose large buckets
    one_shot_small: bool           # small all-reduce buckets go one-shot
    prefetch: bool                 # reverse-order ZeRO-1 param gathers
    ring_threshold: int = RING_THRESHOLD_BYTES
    #: per-bucket drop reasons, for warnings
    drops: Tuple[Tuple[str, str], ...] = ()


def resolve_overlap(modes: Sequence[str], *, accum_steps: int,
                    buckets: Sequence[Bucket], d: int,
                    has_rs: bool) -> OverlapPlan:
    """The per-plan ``overlap=`` values resolved into one schedule (the
    JAX package's ``resolve_overlap``)."""
    explicit = [m for m in modes if m and m != OVERLAP_AUTO]
    if OVERLAP_NONE in explicit:
        mode = OVERLAP_NONE
    elif explicit:
        mode = explicit[0]
    else:
        mode = OVERLAP_AUTO

    drops: List[Tuple[str, str]] = []
    pipeline = False
    if mode in (OVERLAP_AUTO, OVERLAP_PIPELINE, OVERLAP_FULL) \
            and accum_steps > 1:
        pipeline = any(pipeline_eligible(b, mode, accum_steps)
                       for b in buckets)
        for b in buckets:
            why = overlap_drop_reason(
                mode, accum_steps=accum_steps, compressor=b.compressor,
                bucketable=True, explicit_path=True, dtype=b.dtype)
            if why is not None:
                drops.append((b.key, why))
    elif mode == OVERLAP_PIPELINE and accum_steps <= 1:
        for b in buckets:
            drops.append((b.key, overlap_drop_reason(
                OVERLAP_PIPELINE, accum_steps=accum_steps,
                compressor=b.compressor, bucketable=True,
                explicit_path=True, dtype=b.dtype)))

    ring = mode in (OVERLAP_AUTO, OVERLAP_RING, OVERLAP_FULL) and d > 1
    one_shot_small = mode in (OVERLAP_RING, OVERLAP_FULL) and d > 1
    prefetch = (mode in (OVERLAP_AUTO, OVERLAP_RING, OVERLAP_FULL)
                and has_rs)
    return OverlapPlan(mode=mode, pipeline=pipeline, ring=ring,
                       one_shot_small=one_shot_small, prefetch=prefetch,
                       drops=tuple((k, w) for k, w in drops if w))


def reduce_alg(bucket: Bucket, plan: OverlapPlan, d: int) -> str:
    """The lowering of ``bucket``'s reduction: the schedule IR's rule
    (``schedule_ir.py:1199-1210``) without its hierarchical and per-variable
    branches."""
    rs = bucket.mode == MODE_REDUCE_SCATTER
    linear = is_linear_compressor(bucket.compressor)
    qfmt = quant_ring.wire_format_of(bucket.compressor or "")
    if linear and plan.ring and d > 1 \
            and bucket.nbytes >= plan.ring_threshold:
        return ALG_RING
    if linear and plan.one_shot_small and d > 1 and not rs:
        return ALG_ONE_SHOT
    if qfmt is not None and quant_ring.ring_applies(
            plan.mode, bucket.nbytes, d, plan.ring_threshold):
        return ALG_RING
    return ALG_FUSED


def gather_schedule(buckets: Sequence[Bucket],
                    prefetch: bool) -> List[Bucket]:
    """ZeRO-1 parameter-gather issue order: reverse bucket order under
    prefetch (backward fills the last bucket first), else bucket
    order."""
    ordered = sorted(buckets, key=lambda b: b.order)
    return list(reversed(ordered)) if prefetch else ordered


def bucket_reduce_fn(bucket: Bucket, group, n: int) -> Callable:
    """``vec -> mean(vec)`` (all-reduce bucket) or ``vec -> this rank's
    shard of mean(vec)`` (ZeRO-1 bucket) for an UNCOMPRESSED bucket: the
    backend's collective, whatever :func:`reduce_alg` labels it (a linear
    sum's order changes only its last bits)."""
    if n <= 1:
        return lambda v: v
    if bucket.mode == MODE_REDUCE_SCATTER:
        return lambda v: coll.reduce_scatter(v, group) / n
    return lambda v: coll.all_reduce(v, group) / n
