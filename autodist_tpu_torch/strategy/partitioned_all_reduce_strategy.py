"""PartitionedAR: each variable split along axis 0, each shard all-reduced.

Port of the JAX package's ``strategy/partitioned_all_reduce_strategy.py``:
the shard count is the smallest divisor > 1 of dim 0 up to the cap
(``max_shards``, or ``max(len(devices), 2)`` when 0), and every variable
and every shard takes the next collective group id, ``chunk_size`` ids to
a group.  Without a ``model`` mesh axis the partitioner is recorded and
the variable stays replicated on the all-reduce step, as in the JAX
package.
"""
from __future__ import annotations

from autodist_tpu_torch.strategy.base import (AllReduceSynchronizerConfig,
                                              GraphConfig, Strategy,
                                              StrategyBuilder, VarConfig)
from autodist_tpu_torch.strategy.partition_utils import (
    partition_str, partitionable, smallest_divisor_gt_one)


class PartitionedAR(StrategyBuilder):
    """Axis-0 shards, one AllReduce synchronizer each.

    Args:
      max_shards: cap on shards per variable; 0 means the number of compute
        devices (at least 2).
    """

    def __init__(self, chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor", max_shards: int = 0):
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self._chunk_size = chunk_size
        self._spec = all_reduce_spec
        self._compressor = compressor
        self._max_shards = max_shards

    def _choose_axis_and_shards(self, var, cap: int):
        if partitionable(var, 0):
            n = smallest_divisor_gt_one(var.shape[0])
            if n is not None and n <= cap:
                return 0, n
        return None, None

    def _ar(self, counter: int) -> AllReduceSynchronizerConfig:
        return AllReduceSynchronizerConfig(
            spec=self._spec, compressor=self._compressor,
            group=counter // self._chunk_size)

    def build(self, graph_item, resource_spec) -> Strategy:
        node_config = []
        counter = 0
        cap = self._max_shards or max(len(resource_spec.devices), 2)
        for var in graph_item.trainable_var_infos:
            axis, n = self._choose_axis_and_shards(var, cap)
            sync = self._ar(counter)
            counter += 1
            if axis is None:
                node_config.append(VarConfig(var_name=var.name,
                                             synchronizer=sync))
                continue
            parts = [VarConfig(var_name=f"{var.name}/part_{i}",
                               synchronizer=self._ar(counter + i))
                     for i in range(n)]
            counter += n
            node_config.append(VarConfig(
                var_name=var.name,
                partitioner=partition_str(var.shape, axis, n),
                part_config=parts, synchronizer=sync))
        return Strategy(
            node_config=node_config,
            graph_config=GraphConfig(
                replicas=self.replica_devices(resource_spec)))
