"""Parallax: dense gradients all-reduced, sparse (embedding) gradients on
PS.

Port of the JAX package's ``strategy/parallax_strategy.py``: variables
named in ``capture(sparse_vars=...)`` get load-balanced PS synchronizers,
the others AllReduce synchronizers with ``chunk_size`` of them to a
collective group.  On the explicit step the embedding's gradient is
reduce-scattered and its Adam moments held 1/N per rank, while the dense
variables are all-reduced and take the tree update, in one step.
"""
from __future__ import annotations

from autodist_tpu_torch.strategy.base import (AllReduceSynchronizerConfig,
                                              GraphConfig, Strategy,
                                              VarConfig)
from autodist_tpu_torch.strategy.partition_utils import greedy_load_balance
from autodist_tpu_torch.strategy.ps_strategy import PSBuilderBase


class Parallax(PSBuilderBase):
    """Hybrid: AllReduce for dense variables, PS for sparse ones."""

    def __init__(self, chunk_size: int = 128,
                 local_proxy_variable: bool = False, sync: bool = True,
                 staleness: int = 0, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor"):
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        super().__init__(local_proxy_variable, sync, staleness)
        self._chunk_size = chunk_size
        self._spec = all_reduce_spec
        self._compressor = compressor

    def build(self, graph_item, resource_spec) -> Strategy:
        destinations = self.reduction_device_names(resource_spec)
        variables = graph_item.trainable_var_infos
        sparse = [v for v in variables if v.sparse]
        assignment, _ = greedy_load_balance([v.byte_size for v in sparse],
                                            len(destinations))
        sparse_dest = {v.name: destinations[b]
                       for v, b in zip(sparse, assignment)}
        node_config = []
        dense_idx = 0
        for var in variables:
            if var.sparse:
                sync = self._ps(sparse_dest[var.name])
            else:
                sync = AllReduceSynchronizerConfig(
                    spec=self._spec, compressor=self._compressor,
                    group=dense_idx // self._chunk_size)
                dense_idx += 1
            node_config.append(VarConfig(var_name=var.name,
                                         synchronizer=sync))
        return Strategy(
            node_config=node_config,
            graph_config=GraphConfig(
                replicas=self.replica_devices(resource_spec)))
