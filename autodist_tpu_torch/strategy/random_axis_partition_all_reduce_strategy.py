"""RandomAxisPartitionAR: each variable split along a random axis longer
than 1, each shard all-reduced.

Port of the JAX package's
``strategy/random_axis_partition_all_reduce_strategy.py``: a
``random.Random(seed)`` picks the axis, variable by variable in catalog
order (axis 0 for sparse variables), so the same seed picks the same axes
in both packages.  The shard count is the smallest divisor > 1 of that
axis, within the cap of :class:`PartitionedAR` (which here is always the
number of compute devices, at least 2).
"""
from __future__ import annotations

import random

from autodist_tpu_torch.strategy.partition_utils import \
    smallest_divisor_gt_one
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import \
    PartitionedAR


class RandomAxisPartitionAR(PartitionedAR):
    """:class:`PartitionedAR` along a seeded random axis."""

    def __init__(self, chunk_size: int = 128, seed: int = 600,
                 all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor"):
        super().__init__(chunk_size=chunk_size,
                         all_reduce_spec=all_reduce_spec,
                         compressor=compressor)
        self._rng = random.Random(seed)

    def _choose_axis_and_shards(self, var, cap: int):
        if var.sparse:
            candidates = [0] if var.shape and var.shape[0] > 1 else []
        else:
            candidates = [i for i, d in enumerate(var.shape) if d > 1]
        if not candidates:
            return None, None
        axis = self._rng.choice(candidates)
        n = smallest_divisor_gt_one(var.shape[axis])
        if n is None or n > cap:
            return None, None
        return axis, n
