"""PS: every trainable variable synchronized through one parameter server.

Port of the JAX package's ``strategy/ps_strategy.py``: the same
arguments and plan.  Every variable gets a PS synchronizer whose
reduction destination is the first node's CPU; the replicas are all the
compute devices.  The compiler lowers a PS plan to weight-update sharding
on the explicit bucketed step (:mod:`autodist_tpu_torch.strategy.
compiler`); ``staleness > 0`` delays each applied gradient by that many
steps and ``local_proxy_variable=True`` computes against a compute copy
refreshed every ``AUTODIST_PROXY_REFRESH`` steps
(:mod:`autodist_tpu_torch.kernel.synchronization.stale_sync`).
"""
from __future__ import annotations

from autodist_tpu_torch.strategy.base import (GraphConfig,
                                              PSSynchronizerConfig, Strategy,
                                              StrategyBuilder, VarConfig)


class PSBuilderBase(StrategyBuilder):
    """The arguments every PS-family builder takes, and the synchronizer
    they make of them."""

    def __init__(self, local_proxy_variable: bool = False, sync: bool = True,
                 staleness: int = 0):
        self._local_proxy = local_proxy_variable
        self._sync = sync
        self._staleness = staleness

    def _ps(self, destination: str) -> PSSynchronizerConfig:
        return PSSynchronizerConfig(
            reduction_destination=destination,
            local_replication=self._local_proxy, sync=self._sync,
            staleness=self._staleness)



class PS(PSBuilderBase):
    """One PS destination for every variable."""

    def build(self, graph_item, resource_spec) -> Strategy:
        destination = self.reduction_device_names(resource_spec)[0]
        return Strategy(
            node_config=[VarConfig(var_name=var.name,
                                   synchronizer=self._ps(destination))
                         for var in graph_item.trainable_var_infos],
            graph_config=GraphConfig(
                replicas=self.replica_devices(resource_spec)))
