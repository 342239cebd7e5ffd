"""Strategy builders (:class:`AllReduce` and :class:`Zero1`; the PS family
raises until its slice), the Strategy IR and its compiler."""
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizerConfig,
                                              GraphConfig,
                                              PSSynchronizerConfig, Strategy,
                                              StrategyBuilder, VarConfig)
from autodist_tpu_torch.strategy.compiler import (CompiledStrategy,
                                                  StrategyCompiler, VarPlan,
                                                  parse_partitioner)
from autodist_tpu_torch.strategy.ps_family import (PS, Parallax,
                                                   PartitionedPS,
                                                   PSLoadBalancing,
                                                   UnevenPartitionedPS)
from autodist_tpu_torch.strategy.zero1_strategy import Zero1

__all__ = ["AllReduce", "AllReduceSynchronizerConfig", "CompiledStrategy",
           "GraphConfig", "PS", "PSLoadBalancing", "PSSynchronizerConfig",
           "Parallax", "PartitionedPS", "Strategy", "StrategyBuilder",
           "StrategyCompiler", "UnevenPartitionedPS", "VarConfig", "VarPlan",
           "Zero1", "parse_partitioner"]
