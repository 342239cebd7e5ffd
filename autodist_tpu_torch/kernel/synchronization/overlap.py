"""Bucket-collective schedules of the explicit bucketed step.

Port of the JAX package's ``kernel/synchronization/overlap.py``:

* the ``overlap=`` vocabulary and :func:`resolve_overlap`, which turns
  the plans' values into one :class:`OverlapPlan` (an explicit ``"none"``
  wins, then the first explicit mode, else ``"auto"``);
* each bucket's lowering label is the schedule IR's
  (``schedule_ir.build_schedule_ir``, whose bucket nodes the step
  reads): ``"ring"`` at :data:`RING_THRESHOLD_BYTES` and above when the
  plan rings, ``"one_shot"`` for small all-reduce buckets under explicit
  ``"ring"``/``"full"`` and for two-tier buckets, else ``"fused"`` (the
  backend's collective).  A quantized bucket reduces as its label says
  (``quant_ring.quant_bucket_reduce``);
* :func:`bucket_reduce_fn`, the reduction of an uncompressed bucket: the
  backend's ``all_reduce`` / ``reduce_scatter`` whatever its label.  The
  JAX package decomposes a linear ring bucket into ``n - 1`` ``ppermute``
  hops so its schedule can overlap them with backward; the port's step
  is phase-serial, so that decomposition would only add calls (ROADMAP:
  the linear ring lowering waits for a measured NCCL run);
* the ZeRO-1 parameter gathers in :func:`gather_schedule` order (reverse
  bucket order under prefetch; the start-of-step gathers of the buckets
  stored 1/N in bucket order), each one backend ``all_gather``;
* the two-tier (``hier``) collectives (``:438-556``): a data axis of ``d``
  ranks in ``s`` slices reduces a bucket within each slice
  (reduce-scatter), across the slices (one rank per slice: the slower
  network, optionally on the int8 wire, ``AUTODIST_DCN_WIRE=int8``) and
  gathers back within the slice, gated by :func:`hier_applies`.  Under
  ZeRO-1 rank ``g·d_in + i`` then owns global chunk ``i·s + g``
  (:func:`hier_owner`), which the shard update and
  :func:`hier_gather_fn` follow;
* the accumulation pipeline (``:576-760``, :func:`pipelined_accumulate`):
  iteration *k* issues microbatch *k−1*'s bucket collectives, then runs
  microbatch *k*'s backward, so the collective is in flight during the
  backward (on NCCL; the gloo host-staged wire is synchronous).
  A quantized bucket under an explicit ``"pipeline"``/``"full"`` issues
  one quantized collective per slot, its error feedback carried across
  the slots and the last slot's residual kept into the next step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autodist_tpu_torch.kernel.synchronization import collectives as coll
from autodist_tpu_torch.kernel.synchronization import quant_ring
from autodist_tpu_torch.kernel.synchronization.bucketing import (  # noqa: F401
    MODE_REDUCE_SCATTER, OVERLAP_AUTO, OVERLAP_FULL, OVERLAP_MODES,
    OVERLAP_NONE, OVERLAP_PIPELINE, OVERLAP_RING, Bucket, pack_bucket)
from autodist_tpu_torch.telemetry.timeline import sync_span

#: buckets at or above this byte size take the ring lowering
RING_THRESHOLD_BYTES = 256 << 10

#: fraction of the ZeRO-1 param all-gather the cost model treats as
#: hidden behind the next step's prologue under the prefetch issue order
#: (a ranking constant of the JAX package, not a prediction)
PREFETCH_OVERLAP_FRACTION = 0.5

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


def pipeline_applies(overlap: str, *, accum_steps: int, compressor: str,
                     bucketable: bool = True, explicit_path: bool = True,
                     dtype: str = "float32") -> bool:
    """Does accumulation pipelining take effect for this variable?"""
    if overlap not in (OVERLAP_AUTO, OVERLAP_PIPELINE, OVERLAP_FULL):
        return False
    if accum_steps <= 1 or not explicit_path or not bucketable:
        return False
    return overlap_drop_reason(
        overlap, accum_steps=accum_steps, compressor=compressor,
        bucketable=bucketable, explicit_path=explicit_path,
        dtype=dtype) is None


def pipeline_eligible(bucket: Bucket, mode: str, accum_steps: int) -> bool:
    """Does this bucket join the accumulation pipeline under ``mode``?"""
    return pipeline_applies(mode, accum_steps=accum_steps,
                            compressor=bucket.compressor, dtype=bucket.dtype)


def prefetch_applies(overlap: str, *, sync_mode: str,
                     explicit_path: bool = True) -> bool:
    """Is the reverse-order ZeRO-1 param all-gather issue order active?"""
    return (overlap in (OVERLAP_AUTO, OVERLAP_RING, OVERLAP_FULL)
            and sync_mode == MODE_REDUCE_SCATTER and explicit_path)


def explicit_hint(compressor: str, sync_mode: str, bucket_bytes: int,
                  fused: bool = False, overlap: str = OVERLAP_AUTO,
                  hier: bool = False) -> bool:
    """Does ONE plan take the explicit bucketed step (the JAX package's
    rule, mesh-free, read by the analyzer and the cost model)?"""
    if (compressor or "NoneCompressor") != "NoneCompressor":
        return True
    if sync_mode == MODE_REDUCE_SCATTER:
        return True
    if int(bucket_bytes or 0) > 0:
        return True
    if overlap in (OVERLAP_PIPELINE, OVERLAP_RING, OVERLAP_FULL):
        return True
    if hier:
        return True
    return bool(fused)


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


def gather_schedule(buckets: Sequence[Bucket], prefetch: bool,
                    at_start: bool = False) -> List[Bucket]:
    """ZeRO-1 parameter-gather issue order: after the update, reverse
    bucket order under prefetch (backward fills the last bucket first),
    else bucket order; ``at_start``, the start-of-step gathers of the
    buckets stored 1/N, always bucket order (the forward reads the first
    bucket first)."""
    ordered = sorted(buckets, key=lambda b: b.order)
    return list(reversed(ordered)) if prefetch and not at_start \
        else ordered


def bucket_reduce_fn(bucket: Bucket, group, n: int) -> Callable:
    """``vec -> mean(vec)`` (all-reduce bucket) or ``vec -> this rank's
    shard of mean(vec)`` (ZeRO-1 bucket) for an UNCOMPRESSED bucket: the
    backend's collective, whatever the IR labels it (a linear
    sum's order changes only its last bits)."""
    issue = bucket_reduce_issue_fn(bucket, group, n)
    return lambda v: issue(v).wait()


def bucket_reduce_issue_fn(bucket: Bucket, group, n: int) -> Callable:
    """:func:`bucket_reduce_fn`, issued: ``vec -> Pending`` whose
    ``wait()`` gives the mean (or this rank's shard of it)."""
    if n <= 1:
        return coll.done
    rs = bucket.mode == MODE_REDUCE_SCATTER
    collective = coll.reduce_scatter_async if rs else coll.all_reduce_async
    leg = "reduce_scatter" if rs else "all_reduce"

    def issue(v):
        with sync_span(leg):    # the JAX package's inner leg name
            return collective(v, group).then(lambda o: o / n)
    return issue


# -- hierarchical two-tier collectives ---------------------------------------

def hier_applies(d: int, num_slices: int) -> bool:
    """Does the two-tier hierarchy factor this data axis?  ``num_slices``
    > 1 slices that divide the axis evenly, with at least 2 ranks per
    slice (the JAX package's ``schedule_ir.hier_applies``)."""
    d = max(int(d), 1)
    s = max(int(num_slices), 1)
    return s > 1 and d % s == 0 and d // s > 1


def hier_groups(d: int, s: int) -> Tuple[List[List[int]], List[List[int]]]:
    """``(within, across)`` rank lists for a ``d``-rank data axis in ``s``
    slices of ``d // s`` ranks, slice-major (rank ``g * d_in + i`` is
    position ``i`` of slice ``g``): ``within`` groups share a slice,
    ``across`` groups hold the same position in every slice."""
    d_in = d // s
    within = [[g * d_in + i for i in range(d_in)] for g in range(s)]
    across = [[g * d_in + i for g in range(s)] for i in range(d_in)]
    return within, across


def hier_owner(rank: int, d: int, s: int) -> int:
    """The global chunk a two-tier reduce-scatter leaves on ``rank``:
    ``i·s + g`` for rank ``g·d_in + i``."""
    d_in = d // s
    return (rank % d_in) * s + rank // d_in


def _dcn_quantized_sum(sh: torch.Tensor, across, s: int, fmt):
    """The int8/fp8 cross-slice leg: quantize the local partial on the
    per-chunk scale grid (``quant_ring.quantize_blocks``, stateless),
    all-gather payload and scales over the ``across`` group, dequantize
    every slice's contribution and sum them in slice order."""
    q, scales, _sat = quant_ring.quantize_blocks(sh, fmt)
    qs = coll.all_gather(q, across).reshape(s, -1)
    ss = coll.all_gather(scales, across).reshape(s, -1)
    out = torch.zeros_like(sh)
    for j in range(s):
        out = out + quant_ring.dequantize_blocks(qs[j], ss[j])
    return out


def hier_bucket_reduce_fn(bucket: Bucket, within, across, rank: int, d: int,
                          s: int, *, dcn_wire=None) -> Callable:
    """Two-level mean reduction of one bucket: reduce-scatter within the
    slice, one leg across the slices, then (all-reduce buckets) the
    gather within the slice.  ``vec -> mean(vec)`` for all-reduce buckets,
    ``vec -> this rank's shard of mean(vec)`` (global chunk
    :func:`hier_owner`) for ZeRO-1 ones.  ``dcn_wire`` (a
    ``quant_ring.WireFormat`` or None) quantizes the cross-slice leg
    only."""
    slice_idx = rank // (d // s)

    def reduce_ar(v):
        with sync_span("hier_reduce_scatter"):
            sh = coll.reduce_scatter(v, within)
        with sync_span("dcn_all_reduce"):
            if dcn_wire is not None:
                sh = _dcn_quantized_sum(sh, across, s, dcn_wire)
            else:
                sh = coll.all_reduce(sh, across)
        sh = sh / d
        with sync_span("hier_all_gather"):
            return coll.all_gather(sh, within)

    def reduce_rs(v):
        with sync_span("hier_reduce_scatter"):
            sh = coll.reduce_scatter(v, within)
        with sync_span("dcn_exchange"):
            if dcn_wire is not None:
                sh = _dcn_quantized_sum(sh, across, s, dcn_wire)
                sh = sh.reshape(s, -1)[slice_idx]
            else:
                sh = coll.reduce_scatter(sh, across)
        return sh / d

    return reduce_rs if bucket.mode == MODE_REDUCE_SCATTER else reduce_ar


def hier_gather_fn(within, across) -> Callable:
    """ZeRO-1 parameter gather of a two-tier bucket: over ``across``
    first (chunks ``i·s .. i·s+s-1`` in order), then over ``within``,
    which undoes the ownership permutation."""
    def gather(shard):
        with sync_span("hier_all_gather/dcn"):
            part = coll.all_gather(shard, across)
        with sync_span("hier_all_gather/ici"):
            return coll.all_gather(part, within)
    return gather


# -- the accumulation pipeline -----------------------------------------------

def pipelined_accumulate(vg: Callable, slices: Sequence[Tuple[int, int]],
                         rows_of: Callable, has_aux: bool,
                         pipe_buckets: Sequence[Bucket],
                         issue_fns: Dict[str, Callable],
                         quant_fns: Optional[Dict[str, Callable]] = None,
                         quant_states: Optional[Dict] = None,
                         stamp: Optional[Callable] = None):
    """Software-pipelined gradient accumulation over the microbatches
    ``slices`` (``(offset, rows)``, ``rows_of(off, rows)`` gives one):
    iteration *k* issues the bucket collectives of microbatch *k−1*'s
    gradients, then runs microbatch *k*'s backward, then waits for the
    collectives.  ``vg(microbatch) -> (loss, aux, {name: grad})``.

    Returns ``(loss, aux, grads, reduced, quant_state, quant_sat)``:
    ``loss`` the microbatches' mean loss, ``aux`` the auxes stacked on a
    leading axis (or None), ``grads`` the locally averaged gradients of
    every variable outside ``pipe_buckets`` (the other tiers' single
    end-of-step collective), ``reduced`` ``{bucket key: the reduced mean
    vector or this rank's shard}`` of every pipelined bucket,
    ``quant_state`` the last slot's residual per quantized bucket and
    ``quant_sat`` its saturation count summed over the slots.

    The sums follow ``graph_transformer.accumulate``: even microbatches
    add plain and divide once at the end, an uneven tail weights each by
    its share of the rows; the accumulators are f32.  A linear
    ``issue_fns`` leg thus gives the sequential schedule's value up to the
    order of the sums (bit for bit at data size 1).  ``quant_fns[key](vec,
    state) -> (reduced, new_state, sat)`` runs a quantized bucket's
    collective, one per slot.  ``stamp(key, slot)``, when given, runs just
    before each bucket's collective of microbatch ``slot`` (the flight
    recorder's per-slot leg cursor)."""
    quant_fns = quant_fns or {}
    qstate = dict(quant_states or {})
    length = sum(rows for _, rows in slices)
    accum = len(slices)
    even = len({rows for _, rows in slices}) == 1
    weights = [1.0 if even else rows / length for _, rows in slices]
    piped = {n for b in pipe_buckets for n in b.names}
    qsat = {k: None for k in quant_fns}
    red_acc: Dict[str, torch.Tensor] = {}
    acc: Dict = {}
    auxes = []

    def add(store, key, value, w):
        value = w * value.float()
        store[key] = value if key not in store else store[key] + value

    def issue(packed, slot):
        out = {}
        for key, vec in packed.items():
            if stamp is not None:
                stamp(key, slot)
            if key in quant_fns:
                red, qstate[key], cnt = quant_fns[key](vec, qstate.get(key))
                qsat[key] = cnt if qsat[key] is None else qsat[key] + cnt
                out[key] = coll.done(red)
            else:
                out[key] = issue_fns[key](vec)
        return out

    def collect(pending, w):
        for key, p in pending.items():
            add(red_acc, key, p.wait(), w)

    prev, dtypes = None, {}
    for k, (off, rows) in enumerate(slices):
        pending = issue(prev, k - 1) if prev is not None else {}
        loss, aux, grads = vg(rows_of(off, rows))
        collect(pending, weights[k - 1] if k else 1.0)
        auxes.append(aux)
        add(acc, "~loss", loss, weights[k])
        prev = {}
        for b in pipe_buckets:
            prev[b.key] = pack_bucket(b, [grads.pop(n) for n in b.names])
        for n, g in grads.items():
            dtypes[n] = g.dtype
            add(acc, n, g, weights[k])
        del grads
    collect(issue(prev, accum - 1), weights[-1])
    div = accum if even else 1
    loss = acc.pop("~loss") / div
    grads = {n: (a / div).to(dtypes[n]) for n, a in acc.items()
             if n not in piped}
    reduced = {b.key: (red_acc[b.key] / div).to(getattr(torch, b.dtype))
               for b in pipe_buckets}
    aux = None
    if has_aux:
        from autodist_tpu_torch.graph_item import tree_map
        aux = tree_map(lambda *xs: torch.stack(xs), auxes[0], *auxes[1:])
    sat = {k: v for k, v in qsat.items() if v is not None}
    return loss, aux, grads, reduced, qstate, sat
