"""PSLoadBalancing: variables spread over the PS destinations by bytes.

Port of the JAX package's ``strategy/ps_lb_strategy.py`` (the facade's
default builder): each variable, in catalog order, goes to the currently
least-loaded reduction destination, load measured in bytes.
"""
from __future__ import annotations

from autodist_tpu_torch.strategy.base import GraphConfig, Strategy, VarConfig
from autodist_tpu_torch.strategy.partition_utils import greedy_load_balance
from autodist_tpu_torch.strategy.ps_strategy import PSBuilderBase


class PSLoadBalancing(PSBuilderBase):
    """Greedy byte-size balancing of the variables over the PS
    destinations."""

    def build(self, graph_item, resource_spec) -> Strategy:
        destinations = self.reduction_device_names(resource_spec)
        variables = graph_item.trainable_var_infos
        assignment, _ = greedy_load_balance(
            [v.byte_size for v in variables], len(destinations))
        return Strategy(
            node_config=[VarConfig(var_name=var.name,
                                   synchronizer=self._ps(destinations[b]))
                         for var, b in zip(variables, assignment)],
            graph_config=GraphConfig(
                replicas=self.replica_devices(resource_spec)))
