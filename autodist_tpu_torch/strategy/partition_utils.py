"""Shard-count arithmetic of the partitioned strategy builders.

Port of the JAX package's ``strategy/partition_utils.py:12-65``, function
for function: the smallest divisor (``PartitionedPS``,
``PartitionedAR``), the first non-divisor (``UnevenPartitionedPS``), the
``"1,4,1"`` partitioner string and the greedy byte-size load balancing of
``PSLoadBalancing``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def smallest_divisor_gt_one(n: int) -> Optional[int]:
    """Smallest divisor of ``n`` greater than 1 (``n`` itself when it is
    prime), or None if ``n <= 1``."""
    if n <= 1:
        return None
    i = 2
    while i * i <= n:
        if n % i == 0:
            return i
        i += 1
    return n


def first_non_divisor(n: int) -> Optional[int]:
    """Smallest integer > 1 that does NOT divide ``n``, or None when there
    is no useful uneven split (``n <= 2``)."""
    if n <= 2:
        return None
    i = 2
    while n % i == 0:
        i += 1
    return i if i <= n else None


def partition_str(shape: Sequence[int], axis: int, num_shards: int) -> str:
    """The partitioner string of ``num_shards`` shards along ``axis``."""
    parts = ["1"] * len(shape)
    parts[axis] = str(num_shards)
    return ",".join(parts)


def partitionable(var, axis: int = 0) -> bool:
    """``var`` can be split along ``axis``: the dim exists and is longer
    than 1."""
    return len(var.shape) > axis and var.shape[axis] > 1


def greedy_load_balance(sizes: Sequence[float], num_bins: int
                        ) -> Tuple[List[int], List[float]]:
    """Each item, in input order, to the currently least-loaded bin (the
    first on a tie): ``(assignment per item, load per bin)``."""
    loads = [0.0] * num_bins
    assignment = []
    for s in sizes:
        b = loads.index(min(loads))
        assignment.append(b)
        loads[b] += float(s)
    return assignment, loads
