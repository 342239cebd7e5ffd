"""UnevenPartitionedPS: axis-0 shards in a count that does NOT divide the
dim.

Port of the JAX package's ``strategy/uneven_partition_ps_strategy.py``:
the shard count is the first integer > 1 that does not divide dim 0, up
to the cap of :class:`PartitionedPS`.  The JAX package pads such a
variable to shard it; the port's flat buckets pad to the data size
instead (the compiler's docstring).
"""
from __future__ import annotations

from autodist_tpu_torch.strategy.partition_utils import first_non_divisor
from autodist_tpu_torch.strategy.partitioned_ps_strategy import PartitionedPS


class UnevenPartitionedPS(PartitionedPS):
    """:class:`PartitionedPS` with uneven shards."""

    def _num_shards(self, dim0: int, cap: int) -> int:
        n = first_non_divisor(dim0) or 1
        return n if n <= cap else 1
