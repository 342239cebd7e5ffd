"""StrategyCompiler: lower a Strategy onto the mesh.

Port of the JAX package's ``strategy/compiler.py:93-486`` for the port's
mesh, which has a ``data`` axis only.  Each per-variable config becomes a
:class:`VarPlan`.

* **AllReduce** plans average the gradient over ``data`` and carry
  ``compressor``, ``sync_mode`` (``"reduce_scatter"`` for ZeRO-1 weight-
  update sharding), ``bucket_bytes``, ``overlap`` and ``hier`` to the
  step unchanged (``compiler.py:436-455``).  A partitioner shards only
  over a ``model`` axis, so partitioned AllReduce variables stay
  replicated, as they do in the JAX package on a data-only mesh.
* **PS** plans are weight-update sharding (``compiler.py:457-484``): the
  plan reduce-scatters the gradient over ``data`` (``sync_mode=
  "reduce_scatter"``, no compressor, the default bucket cap), so the
  explicit bucketed step updates this rank's 1/N share of the optimizer
  state, the ZeRO-1 path.  The plan records the reduction destination,
  the partitioner's axis and shard count, the sparse flag, ``staleness``
  (the delay of bounded staleness) and ``local_replication`` (proxy
  variables), which the step runs
  (``kernel/synchronization/stale_sync.py``).  ``sync=False`` is carried
  along and the step stays bulk-synchronous, as in the JAX package.
* **Parameter storage** (``storage_axis``): the dim the JAX lowering
  shards the parameter over ``data`` between steps (its ``param_spec``,
  ``compiler.py:457-484``): a partitioner's axis under PS, and axis 0 for
  a sparse variable on PS without one (the vocab-axis shard of the
  Parallax lowering).  Such a variable is stored 1/N per rank between
  steps at data size > 1 (:meth:`CompiledStrategy.stored_vars`), unless,
  as in the JAX lowering, padding the dim to a multiple of the data size
  would at least double it; every other parameter keeps a replicated
  copy.

The compiled strategy carries the resource spec's ``num_slices``, the
two-tier topology ``hier`` buckets reduce over, and
:meth:`CompiledStrategy.fusable_groups`, the groups ``fused_groups``
fuses (``compiler.py:141-170, 243``).

One difference from the JAX lowering, which changes no loss or
parameter: a variable stored 1/N lives in a flat ZeRO-1 bucket, and a
rank holds its chunk of that bucket, not JAX's slice of the variable
along ``storage_axis``; where the JAX package pads a dim that does not
divide the data size (``pad_axis``: ``UnevenPartitionedPS``, an
indivisible vocab), the flat bucket is padded to a multiple of the data
size instead.  For a bucket of one variable stored along axis 0 whose
rows divide by the data size, the chunk is JAX's shard, row for row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from autodist_tpu_torch.kernel.synchronization.bucketing import \
    MODE_REDUCE_SCATTER
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizerConfig,
                                              PSSynchronizerConfig, Strategy)


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
    """Lowered per-variable plan: the synchronizer kind (``"AllReduce"``
    or ``"PS"``), the gradient's sync mode (``"all_reduce"`` or
    ``"reduce_scatter"``), the bucket options and, for PS, the
    destination, partitioner, sparse flag, staleness, proxy flag and the
    storage axis (None: a replicated parameter)."""

    var_name: str
    sync_kind: str = "AllReduce"
    compressor: str = "NoneCompressor"
    group: int = 0
    fused: bool = False
    sync_mode: str = "all_reduce"
    bucket_bytes: int = 0
    overlap: str = "auto"
    hier: bool = False
    reduction_destination: str = ""
    partition_axis: Optional[int] = None
    num_shards: int = 1
    sparse: bool = False
    staleness: int = 0
    local_replication: bool = False
    storage_axis: Optional[int] = None
    storage_dim: int = 0

    def stored_at(self, data: int) -> bool:
        """Is the parameter stored 1/N at data size ``data``?  Not when
        padding its storage dim to a multiple of ``data`` would at least
        double it (the JAX lowering keeps such a variable replicated)."""
        if self.storage_axis is None:
            return False
        dim, d = self.storage_dim, max(int(data), 1)
        return not (dim % d and -(-dim // d) * d >= 2 * dim)


@dataclass
class CompiledStrategy:
    """A Strategy bound to a mesh: the per-variable plans and the slice
    count of the two-tier topology (1: flat)."""

    strategy: Strategy
    mesh: object
    var_plans: Dict[str, VarPlan]
    num_slices: int = 1

    def fusable_groups(self) -> Dict[int, List[str]]:
        """Collective groups with >= 2 uncompressed AllReduce variables:
        what ``fused_groups`` merges into one collective."""
        by_group: Dict[int, List[str]] = {}
        for name, plan in self.var_plans.items():
            if plan.sync_kind != "AllReduce":
                continue
            if (plan.compressor or "NoneCompressor") != "NoneCompressor":
                continue
            by_group.setdefault(plan.group, []).append(name)
        return {g: ns for g, ns in by_group.items() if len(ns) >= 2}

    def stored_vars(self, data: Optional[int] = None) -> Tuple[str, ...]:
        """The variables stored 1/N per rank between steps at data size
        ``data`` (default: the mesh's), the JAX lowering's ``param_spec``
        over ``data`` (none at size 1)."""
        if data is None:
            data = getattr(self.mesh, "data_size", 1)
        return tuple(name for name, plan in self.var_plans.items()
                     if data > 1 and plan.stored_at(data))


class StrategyCompiler:
    """Compile ``Strategy × GraphItem × Mesh → CompiledStrategy``."""

    def __init__(self, mesh, resource_spec=None):
        self.mesh = mesh
        self.num_slices = int(getattr(resource_spec, "num_slices", 1) or 1)

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
                                var_plans=plans, num_slices=self.num_slices)

    def _compile_node(self, node, var) -> VarPlan:
        axis, num_shards = parse_partitioner(node.partitioner)
        if axis is not None and (len(var.shape) <= axis
                                 or var.shape[axis] < 2):
            raise ValueError(
                f"partitioner {node.partitioner!r} invalid for {var.name} "
                f"with shape {var.shape}")
        sync = node.synchronizer
        if isinstance(sync, PSSynchronizerConfig):
            storage = axis
            if (var.sparse and axis is None and var.shape
                    and not (var.pipeline or var.expert)):
                storage = 0     # the vocab-axis shard of a sparse table
            return VarPlan(
                var_name=var.name, sync_kind="PS",
                sync_mode=MODE_REDUCE_SCATTER,
                reduction_destination=sync.reduction_destination,
                partition_axis=axis, num_shards=num_shards,
                sparse=var.sparse, staleness=int(sync.staleness),
                local_replication=bool(sync.local_replication),
                storage_axis=storage,
                storage_dim=var.shape[storage] if storage is not None else 0)
        if not isinstance(sync, AllReduceSynchronizerConfig):
            raise ValueError(f"node {node.var_name} has no synchronizer")
        return VarPlan(
            var_name=var.name, compressor=sync.compressor, group=sync.group,
            fused=sync.fused, sync_mode=sync.sync or "all_reduce",
            bucket_bytes=int(sync.bucket_bytes or 0),
            overlap=sync.overlap or "auto", hier=bool(sync.hier))
