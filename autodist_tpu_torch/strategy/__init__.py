"""Strategy builders (:class:`AllReduce` and :class:`Zero1`; the PS family
and the partitioned all-reduce builders raise until their slice,
:class:`AutoStrategy` until P8), the Strategy IR and its compiler."""
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.auto_strategy import AutoStrategy
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizerConfig,
                                              GraphConfig,
                                              PSSynchronizerConfig, Strategy,
                                              StrategyBuilder, VarConfig)
from autodist_tpu_torch.strategy.compiler import (CompiledStrategy,
                                                  StrategyCompiler, VarPlan,
                                                  parse_partitioner)
from autodist_tpu_torch.strategy.ps_family import (PS, Parallax,
                                                   PartitionedAR,
                                                   PartitionedPS,
                                                   PSLoadBalancing,
                                                   RandomAxisPartitionAR,
                                                   UnevenPartitionedPS)
from autodist_tpu_torch.strategy.zero1_strategy import Zero1

__all__ = ["AllReduce", "AllReduceSynchronizerConfig", "AutoStrategy",
           "CompiledStrategy", "GraphConfig", "PS", "PSLoadBalancing",
           "PSSynchronizerConfig", "Parallax", "PartitionedAR",
           "PartitionedPS", "RandomAxisPartitionAR", "Strategy",
           "StrategyBuilder", "StrategyCompiler", "UnevenPartitionedPS",
           "VarConfig", "VarPlan", "Zero1", "parse_partitioner"]
