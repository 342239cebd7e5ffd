"""Gradient-bucket planning.

Port of the JAX package's ``kernel/synchronization/bucketing.py:44-221``.
Gradients are flattened and concatenated into contiguous, size-capped,
dtype-grouped vectors, and the data-parallel step issues ONE collective
per bucket instead of one per variable.  The planner is a pure function of
``(name, shape, dtype, compressor, group, mode)`` and gives the same plan
and the same ``Bucket.key`` as the JAX package for the same inputs.

Keying: ``(mode, dtype, compressor, group)``; within a key variables fill
greedily in catalog order until ``bucket_bytes`` is reached, and a single
variable larger than the cap gets a bucket of its own (never split).

Storage: an entry may carry a seventh field, ``stored`` (the parameter
is stored 1/N per rank between steps, ``VarPlan.storage_axis``).  A
bucket's members are then all stored that way or none is: a member whose
flag differs from the open bucket's closes it first, as an oversized
member does, so the keys keep the JAX package's form and a plan whose
stored variables each fill a bucket of their own (every full-width
model's embedding tables) is the JAX planner's plan.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autodist_tpu_torch.graph_item import itemsize as _itemsize

#: default bucket size cap
DEFAULT_BUCKET_BYTES = 4 << 20

MODE_ALL_REDUCE = "all_reduce"
MODE_REDUCE_SCATTER = "reduce_scatter"
SYNC_MODES = (MODE_ALL_REDUCE, MODE_REDUCE_SCATTER)
#: the bucket-collective schedules of the JAX package (``overlap.py``)
OVERLAP_MODES = ("auto", "none", "pipeline", "ring", "full")
OVERLAP_AUTO, OVERLAP_NONE, OVERLAP_PIPELINE, OVERLAP_RING, OVERLAP_FULL = \
    OVERLAP_MODES


@dataclass(frozen=True)
class BucketVar:
    """One variable's slot inside a bucket."""

    name: str
    shape: Tuple[int, ...]
    offset: int          # element offset into the bucket vector

    @property
    def size(self) -> int:
        return int(np.prod(self.shape or (1,)))


@dataclass(frozen=True)
class Bucket:
    """A planned contiguous gradient bucket (one collective)."""

    key: str
    mode: str
    dtype: str
    compressor: str
    group: int
    vars: Tuple[BucketVar, ...]
    total: int           # sum of member sizes (elements, unpadded)
    padded_total: int    # total rounded up to the shard divisor
    order: int = 0
    stored: bool = False  # members stored 1/N between steps

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(v.name for v in self.vars)

    @property
    def nbytes(self) -> int:
        """Unpadded bytes (what the ring threshold compares)."""
        return self.total * _itemsize(self.dtype)

    @property
    def pad(self) -> int:
        return self.padded_total - self.total


#: the JAX package's compressors whose state is not flat-composable
_UNBUCKETABLE = ("PowerSGDCompressor",)
_COMPRESSORS = ("NoneCompressor", "HorovodCompressor", "HorovodCompressorEF",
                "PowerSGDCompressor", "Int8Compressor", "Fp8Compressor")


def bucket_drop_reason(placement: Sequence, padded: bool,
                       compressor: str) -> Optional[str]:
    """Why a variable cannot join a gradient bucket, or None when it can
    (the JAX package's rule, ``bucketing.py:101-124``).  ``placement`` is
    the non-trivial part of the variable's layout; a partitioned variable
    owns a per-shard collective."""
    if list(placement):
        return "partitioned/structurally sharded (owns a per-shard collective)"
    if padded:
        return "pad-to-divisible sharding"
    name = compressor or "NoneCompressor"
    if name not in _COMPRESSORS:
        return f"unknown compressor {compressor!r}"
    if name in _UNBUCKETABLE:
        return (f"{compressor} state is not flat-composable "
                f"(e.g. PowerSGD low-rank factors)")
    return None


def assign_buckets(entries: Sequence[Tuple],
                   bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                   shard_divisor: int = 1) -> List[Bucket]:
    """Plan buckets over ``entries`` = [(name, shape, dtype, compressor,
    group, mode[, stored]), ...] in catalog order.  ``bucket_bytes`` caps
    each bucket's unpadded byte size (0 or None: the default);
    ``shard_divisor`` rounds ``padded_total`` up to a multiple of it."""
    cap = int(bucket_bytes) if bucket_bytes else DEFAULT_BUCKET_BYTES
    d = max(int(shard_divisor), 1)
    open_buckets: Dict[Tuple, List[BucketVar]] = {}
    first_touch: List[Tuple] = []
    closed: List[Tuple[Tuple, List[BucketVar]]] = []
    seq: Dict[Tuple, int] = {}
    stored_of: Dict[Tuple, bool] = {}   # the open bucket's storage

    def close(bkey: Tuple) -> None:
        members = open_buckets.pop(bkey, None)
        if members:
            closed.append((bkey + (seq[bkey], stored_of[bkey]), members))
            seq[bkey] = seq[bkey] + 1

    for entry in entries:
        name, shape, dtype, compressor, group, mode = entry[:6]
        stored = bool(entry[6]) if len(entry) > 6 else False
        if mode not in SYNC_MODES:
            raise ValueError(f"unknown sync mode {mode!r} for {name}; "
                             f"expected one of {SYNC_MODES}")
        size = int(np.prod(tuple(shape) or (1,)))
        itemsize = _itemsize(dtype)
        bkey = (mode, str(dtype), compressor or "NoneCompressor", int(group))
        if bkey not in seq:
            seq[bkey] = 0
            first_touch.append(bkey)
        members = open_buckets.get(bkey)
        current = sum(v.size for v in members) if members else 0
        if members and ((current + size) * itemsize > cap
                        or stored_of[bkey] != stored):
            close(bkey)   # cap reached or storage changes: a fresh bucket
            members = None
            current = 0
        if members is None:
            members = open_buckets.setdefault(bkey, [])
            stored_of[bkey] = stored
        members.append(BucketVar(name=name, shape=tuple(shape),
                                 offset=current))
        if (current + size) * itemsize >= cap:
            close(bkey)   # an oversized variable still gets one bucket
    for bkey in first_touch:
        close(bkey)

    buckets: List[Bucket] = []
    for order, ((mode, dtype, compressor, group, idx, stored), members) \
            in enumerate(closed):
        total = sum(v.size for v in members)
        comp_tag = "" if compressor in ("", "NoneCompressor") \
            else f"{compressor}:"
        buckets.append(Bucket(
            key=f"{mode}:{dtype}:{comp_tag}g{group}:{idx}",
            mode=mode, dtype=dtype, compressor=compressor, group=int(group),
            vars=tuple(members), total=total,
            padded_total=-(-total // d) * d, order=order, stored=stored))
    return buckets


def pack_bucket(bucket: Bucket, leaves: Sequence[torch.Tensor]
                ) -> torch.Tensor:
    """Concatenate ``leaves`` (bucket order) into the padded flat vector."""
    parts = [x.reshape(-1) for x in leaves]
    if bucket.pad:
        parts.append(parts[0].new_zeros(bucket.pad))
    return torch.cat(parts) if len(parts) > 1 else parts[0].clone()


def unpack_bucket(bucket: Bucket, vec: torch.Tensor) -> List[torch.Tensor]:
    """Split the flat vector back into member-shaped views."""
    return [vec[v.offset:v.offset + v.size].view(v.shape)
            for v in bucket.vars]


def member_spans(bucket: Bucket, index: int, shard: int
                 ) -> List[Tuple[int, int]]:
    """Per member, the ``(start, stop)`` of its flattened elements that
    chunk ``index`` (``shard`` elements long) of the bucket vector holds;
    ``start == stop`` for a member outside the chunk.  The members' spans
    lie in the chunk one after another, in bucket order, and the pad
    follows them."""
    lo, hi = index * shard, (index + 1) * shard
    spans = []
    for v in bucket.vars:
        a = min(max(lo, v.offset), v.offset + v.size) - v.offset
        b = max(min(hi, v.offset + v.size), v.offset) - v.offset
        spans.append((a, max(a, b)))
    return spans
