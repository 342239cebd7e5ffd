"""StrategyCompiler: lower a Strategy onto the mesh.

Port of the JAX package's ``strategy/compiler.py:93-486`` for what the
port runs: AllReduce plans over the ``data`` axis.  Each per-variable
config becomes a :class:`VarPlan`; the parameter is replicated on every
rank and the gradient is averaged over ``data`` (no collective at data
size 1).  The plan carries ``compressor``, ``sync_mode``
(``"reduce_scatter"`` for ZeRO-1 weight-update sharding),
``bucket_bytes``, ``overlap`` and ``hier`` through to the step unchanged
(``compiler.py:436-455``).  A partitioner shards only
over a ``model`` axis, which a mesh of the port does not have yet, so
partitioned AllReduce variables stay replicated, as they do in the JAX
package on a pure data-parallel mesh.  PS plans raise, naming their
slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from autodist_tpu_torch.const import not_ported
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizerConfig,
                                              PSSynchronizerConfig, Strategy)
from autodist_tpu_torch.strategy.ps_family import ITEM as PS_ITEM


def parse_partitioner(partitioner: str) -> Tuple[Optional[int], int]:
    """``"1,4,1"`` → (active_axis, num_shards); ("" or all ones) →
    (None, 1).  At most one active axis."""
    if not partitioner:
        return None, 1
    parts = [int(x) for x in partitioner.split(",")]
    active = [(i, p) for i, p in enumerate(parts) if p > 1]
    if not active:
        return None, 1
    if len(active) > 1:
        raise ValueError(
            f"partitioner {partitioner!r} has more than one active axis")
    return active[0]


@dataclass
class VarPlan:
    """Lowered per-variable plan: replicated parameter, the gradient's
    sync mode (``"all_reduce"`` or ``"reduce_scatter"``) and the bucket
    options."""

    var_name: str
    compressor: str = "NoneCompressor"
    group: int = 0
    fused: bool = False
    sync_mode: str = "all_reduce"
    bucket_bytes: int = 0
    overlap: str = "auto"
    hier: bool = False


@dataclass
class CompiledStrategy:
    """A Strategy bound to a mesh: the per-variable plans."""

    strategy: Strategy
    mesh: object
    var_plans: Dict[str, VarPlan]


class StrategyCompiler:
    """Compile ``Strategy × GraphItem × Mesh → CompiledStrategy``."""

    def __init__(self, mesh):
        self.mesh = mesh

    def compile(self, strategy: Strategy, graph_item) -> CompiledStrategy:
        plans: Dict[str, VarPlan] = {}
        known = {v.name: v for v in graph_item.info.variables}
        for node in strategy.node_config:
            var = known.get(node.var_name)
            if var is None or not var.trainable:
                continue    # unknown or frozen: pruned, as in the JAX package
            plans[var.name] = self._compile_node(node, var)
        for name, var in known.items():
            if var.trainable and name not in plans:
                plans[name] = VarPlan(var_name=name)   # replicate + average
        return CompiledStrategy(strategy=strategy, mesh=self.mesh,
                                var_plans=plans)

    def _compile_node(self, node, var) -> VarPlan:
        axis, _ = parse_partitioner(node.partitioner)
        if axis is not None and (len(var.shape) <= axis
                                 or var.shape[axis] < 2):
            raise ValueError(
                f"partitioner {node.partitioner!r} invalid for {var.name} "
                f"with shape {var.shape}")
        sync = node.synchronizer
        if isinstance(sync, PSSynchronizerConfig):
            raise not_ported(f"the PS synchronizer of {var.name}", PS_ITEM)
        if not isinstance(sync, AllReduceSynchronizerConfig):
            raise ValueError(f"node {node.var_name} has no synchronizer")
        return VarPlan(
            var_name=var.name, compressor=sync.compressor, group=sync.group,
            fused=sync.fused, sync_mode=sync.sync or "all_reduce",
            bucket_bytes=int(sync.bucket_bytes or 0),
            overlap=sync.overlap or "auto", hier=bool(sync.hier))
