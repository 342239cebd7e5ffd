"""Strategy builders (:class:`AllReduce`, :class:`Zero1`, the PS family,
the partitioned all-reduce builders and :class:`AutoStrategy`, whose
``search=`` ranks or beam-searches by the cost model), the Strategy IR,
its compiler, and the :class:`ScheduleTuner` that re-searches on drift
and hot-swaps a running session's schedule."""
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.auto_strategy import AutoStrategy
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizerConfig,
                                              GraphConfig,
                                              PSSynchronizerConfig, Strategy,
                                              StrategyBuilder, VarConfig)
from autodist_tpu_torch.strategy.compiler import (CompiledStrategy,
                                                  StrategyCompiler, VarPlan,
                                                  parse_partitioner)
from autodist_tpu_torch.strategy.cost_model import (CostReport,
                                                    estimate_cost,
                                                    plan_fingerprint,
                                                    rank_strategies)
from autodist_tpu_torch.strategy.parallax_strategy import Parallax
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import \
    PartitionedAR
from autodist_tpu_torch.strategy.partitioned_ps_strategy import PartitionedPS
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing
from autodist_tpu_torch.strategy.ps_strategy import PS
from autodist_tpu_torch.strategy.search import (SearchResult, SearchSpace,
                                                beam_search)
from autodist_tpu_torch.strategy.random_axis_partition_all_reduce_strategy \
    import RandomAxisPartitionAR
from autodist_tpu_torch.strategy.uneven_partition_ps_strategy import \
    UnevenPartitionedPS
from autodist_tpu_torch.strategy.tuner import ScheduleTuner
from autodist_tpu_torch.strategy.zero1_strategy import Zero1

__all__ = [
    "AllReduce", "AllReduceSynchronizerConfig", "AutoStrategy",
    "CompiledStrategy", "CostReport",
    "GraphConfig", "PS", "PSLoadBalancing", "PSSynchronizerConfig", "Parallax",
    "PartitionedAR", "PartitionedPS", "RandomAxisPartitionAR",
    "ScheduleTuner", "SearchResult", "SearchSpace", "Strategy",
    "StrategyBuilder", "StrategyCompiler", "UnevenPartitionedPS", "VarConfig",
    "VarPlan", "Zero1", "beam_search", "estimate_cost", "parse_partitioner",
    "plan_fingerprint", "rank_strategies",
]
