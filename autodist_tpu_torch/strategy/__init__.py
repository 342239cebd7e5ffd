"""Strategy builders (:class:`AllReduce`, :class:`Zero1`, the PS family
and the partitioned all-reduce builders; :class:`AutoStrategy` raises
until P8), the Strategy IR and its compiler."""
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.auto_strategy import AutoStrategy
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizerConfig,
                                              GraphConfig,
                                              PSSynchronizerConfig, Strategy,
                                              StrategyBuilder, VarConfig)
from autodist_tpu_torch.strategy.compiler import (CompiledStrategy,
                                                  StrategyCompiler, VarPlan,
                                                  parse_partitioner)
from autodist_tpu_torch.strategy.parallax_strategy import Parallax
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import \
    PartitionedAR
from autodist_tpu_torch.strategy.partitioned_ps_strategy import PartitionedPS
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing
from autodist_tpu_torch.strategy.ps_strategy import PS
from autodist_tpu_torch.strategy.random_axis_partition_all_reduce_strategy \
    import RandomAxisPartitionAR
from autodist_tpu_torch.strategy.uneven_partition_ps_strategy import \
    UnevenPartitionedPS
from autodist_tpu_torch.strategy.zero1_strategy import Zero1

__all__ = ["AllReduce", "AllReduceSynchronizerConfig", "AutoStrategy",
           "CompiledStrategy", "GraphConfig", "PS", "PSLoadBalancing",
           "PSSynchronizerConfig", "Parallax", "PartitionedAR",
           "PartitionedPS", "RandomAxisPartitionAR", "Strategy",
           "StrategyBuilder", "StrategyCompiler", "UnevenPartitionedPS",
           "VarConfig", "VarPlan", "Zero1", "parse_partitioner"]
