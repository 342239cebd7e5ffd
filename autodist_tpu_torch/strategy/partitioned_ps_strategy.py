"""PartitionedPS: each variable split along axis 0, the shards balanced
over the PS destinations.

Port of the JAX package's ``strategy/partitioned_ps_strategy.py``: the
shard count is the smallest divisor > 1 of dim 0, kept only up to the cap
(``max_shards``, or ``max(len(devices), 2)`` when 0); the shards of all
variables, in catalog order, are greedily balanced by bytes; a variable
that cannot be split keeps a plain PS synchronizer.  The port's lowering
records the partitioner and keeps the parameter whole (the compiler's
docstring says why).
"""
from __future__ import annotations

from autodist_tpu_torch.strategy.base import GraphConfig, Strategy, VarConfig
from autodist_tpu_torch.strategy.partition_utils import (
    greedy_load_balance, partition_str, partitionable,
    smallest_divisor_gt_one)
from autodist_tpu_torch.strategy.ps_strategy import PSBuilderBase


class PartitionedPS(PSBuilderBase):
    """Axis-0 shards, each load-balanced onto a PS destination.

    Args:
      max_shards: cap on shards per variable; 0 means the number of compute
        devices (at least 2), so a prime-length axis does not split into
        one shard per element.
    """

    def __init__(self, local_proxy_variable: bool = False, sync: bool = True,
                 staleness: int = 0, max_shards: int = 0):
        super().__init__(local_proxy_variable, sync, staleness)
        self._max_shards = max_shards

    def _num_shards(self, dim0: int, cap: int) -> int:
        n = smallest_divisor_gt_one(dim0) or 1
        return n if n <= cap else 1

    def build(self, graph_item, resource_spec) -> Strategy:
        destinations = self.reduction_device_names(resource_spec)
        cap = self._max_shards or max(len(resource_spec.devices), 2)
        pending = []                      # (var, shards)
        shard_bytes = []
        for var in graph_item.trainable_var_infos:
            n = self._num_shards(var.shape[0], cap) \
                if partitionable(var) else 1
            pending.append((var, n))
            shard_bytes.extend([var.byte_size / n] * n)
        assignment, _ = greedy_load_balance(shard_bytes, len(destinations))
        node_config = []
        cursor = 0
        for var, n in pending:
            dests = [destinations[b] for b in assignment[cursor:cursor + n]]
            cursor += n
            if n == 1:
                node_config.append(VarConfig(
                    var_name=var.name, synchronizer=self._ps(dests[0])))
                continue
            node_config.append(VarConfig(
                var_name=var.name,
                partitioner=partition_str(var.shape, 0, n),
                part_config=[VarConfig(var_name=f"{var.name}/part_{i}",
                                       synchronizer=self._ps(d))
                             for i, d in enumerate(dests)],
                synchronizer=self._ps(dests[0])))
        return Strategy(
            node_config=node_config,
            graph_config=GraphConfig(
                replicas=self.replica_devices(resource_spec)))
