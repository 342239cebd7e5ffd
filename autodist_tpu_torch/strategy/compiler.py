"""StrategyCompiler: lower a Strategy onto the mesh.

Port of the JAX package's ``strategy/compiler.py:93-486`` for the port's
mesh (``pipe``, ``data``, ``expert``, ``seq`` and ``model`` axes).  Each
per-variable config becomes a :class:`VarPlan`; ``param_spec`` and
``opt_spec`` are the JAX plan's ``PartitionSpec`` entries as a tuple
(trailing Nones trimmed, ``()`` replicated), ``pad_axis``/``pad_dim``
its pad-to-divisible sharding (``_partition_spec``,
``compiler.py:286-330``: a dim that does not divide the axis pads to the
next multiple, unless that would at least double it, which keeps the
variable replicated with the JAX warning).

* **AllReduce** plans average the gradient over ``data`` and carry
  ``compressor``, ``sync_mode`` (``"reduce_scatter"`` for ZeRO-1 weight-
  update sharding), ``bucket_bytes``, ``overlap`` and ``hier`` to the
  step unchanged (``compiler.py:436-455``).  A partitioner shards the
  variable over the ``model`` axis when the mesh has one
  (``partition_axis``/``num_shards`` are set only then); on a mesh
  without it the partitioned variable stays replicated, as in the JAX
  package.
* **PS** plans are weight-update sharding (``compiler.py:457-484``): the
  plan reduce-scatters the gradient over ``data`` (``sync_mode=
  "reduce_scatter"``, no compressor, the default bucket cap), so the
  explicit bucketed step updates this rank's 1/N share of the optimizer
  state, the ZeRO-1 path.  A partitioner shards over ``model`` when the
  mesh has one, else over ``data``; a sparse variable without one shards
  its vocab axis the same way.  A variable sharded over ``model`` keeps
  its moments with its shard (``opt_spec = param_spec``): its plan is an
  ``"all_reduce"`` of the shard over ``data``, the bucketed step's
  per-shard tier, unless its sharding is padded, which the bucketed step
  replicates (``explicit_sync.partition_drop_reason``) and so shards its
  update over ``data`` as any other PS variable.  The plan records the
  reduction destination, the partitioner's axis and shard count, the
  sparse flag, ``staleness`` (the delay of bounded staleness) and
  ``local_replication`` (proxy variables), which the step runs
  (``kernel/synchronization/stale_sync.py``).  ``sync=False`` is carried
  along and the step stays bulk-synchronous, as in the JAX package.
* **The pipe and expert axes** are structural (``compiler.py:401-469``):
  dim 0 of a ``pipeline_vars`` stack shards over ``pipe``, and the
  expert dim of an ``expert_vars`` stack (dim 0, or dim 1 after a stage
  dim) over ``expert``, after the synchronizer's lowering (under
  AllReduce after the partition, under PS before ``_wus_opt_spec`` fills
  a free dim with ``data``), in every plan, the untouched variables' too;
  a partitioner may not claim those dims.  A stack sharded over
  ``expert`` or ``pipe`` alone, or over ``pipe`` and ``expert``, takes
  the per-shard tier as a model-sharded variable does
  (:func:`per_shard_spec`); a variable sharded over two axes other than
  that pair is replicated on the bucketed step, with the JAX warning.
* **Parameter storage over data** (``storage_axis``): the dim the JAX
  lowering shards the parameter over ``data`` between steps on a mesh
  without ``model`` (its ``param_spec``): a partitioner's axis under PS,
  and axis 0 for a sparse variable on PS without one (the vocab-axis
  shard of the Parallax lowering).  Such a variable is stored 1/N per
  rank between steps at data size > 1 (:meth:`CompiledStrategy.
  stored_vars`), unless, as in the JAX lowering, padding the dim to a
  multiple of the data size would at least double it; every other
  parameter keeps a replicated copy.  On a ``model`` mesh those
  variables shard over ``model`` instead and nothing is stored over
  ``data``.

The compiled strategy carries the resource spec's ``num_slices``, the
two-tier topology ``hier`` buckets reduce over, and
:meth:`CompiledStrategy.fusable_groups`, the groups ``fused_groups``
fuses (``compiler.py:141-170, 243``).

One difference from the JAX lowering, which changes no loss or
parameter: a variable stored 1/N over ``data`` lives in a flat ZeRO-1
bucket, and a rank holds its chunk of that bucket, not JAX's slice of
the variable along ``storage_axis``; where the JAX package pads a dim
that does not divide the data size (``pad_axis``: ``UnevenPartitionedPS``,
an indivisible vocab), the flat bucket is padded to a multiple of the
data size instead.  For a bucket of one variable stored along axis 0
whose rows divide by the data size, the chunk is JAX's shard, row for
row.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from autodist_tpu_torch.const import (MESH_AXIS_DATA, MESH_AXIS_EXPERT,
                                      MESH_AXIS_MODEL, MESH_AXIS_PIPE,
                                      SHARD_AXES)
from autodist_tpu_torch.kernel.synchronization.bucketing import \
    MODE_REDUCE_SCATTER
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizerConfig,
                                              PSSynchronizerConfig, Strategy)


log = logging.getLogger(__name__)
_warned: set = set()


def _warn_once(fmt: str, *args) -> None:
    key = (fmt,) + args
    if key not in _warned:
        _warned.add(key)
        log.warning(fmt, *args)


def spec_from_entries(entries) -> Tuple[Optional[str], ...]:
    """The entries with trailing Nones trimmed: a ``PartitionSpec`` as a
    tuple (``()`` replicated)."""
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


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
    ``"reduce_scatter"``), the bucket options, the layouts of the JAX
    plan (``param_spec``, ``opt_spec``, ``pad_axis``/``pad_dim``) and,
    for PS, the destination, partitioner, sparse flag, staleness, proxy
    flag and the storage axis over ``data`` (None: not stored 1/N)."""

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
    param_spec: Tuple[Optional[str], ...] = ()
    opt_spec: Tuple[Optional[str], ...] = ()
    pad_axis: Optional[int] = None
    pad_dim: int = 0

    @property
    def model_sharded(self) -> bool:
        """Does ``param_spec`` shard a dim over ``model``, ``expert`` or
        ``pipe`` without padding it (a sharding the bucketed step
        keeps)?"""
        return self.pad_axis is None and any(
            a in SHARD_AXES for a in self.param_spec)

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

    def pad_plans(self) -> Dict[str, Tuple[int, int]]:
        """Variables with pad-to-divisible sharding: name → (axis, padded
        dim)."""
        return {n: (p.pad_axis, p.pad_dim)
                for n, p in self.var_plans.items() if p.pad_axis is not None}

    def fusable_groups(self) -> Dict[int, List[str]]:
        """Collective groups with >= 2 uncompressed replicated AllReduce
        variables: what ``fused_groups`` merges into one collective."""
        by_group: Dict[int, List[str]] = {}
        for name, plan in self.var_plans.items():
            if plan.sync_kind != "AllReduce" or plan.param_spec:
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
    """Compile ``Strategy × GraphItem × Mesh → CompiledStrategy``.  The
    mesh may be None: every axis is then of size 1 (a data size is given
    where the plan is used, :meth:`VarPlan.stored_at`)."""

    def __init__(self, mesh, resource_spec=None):
        self.mesh = mesh
        self.num_slices = int(getattr(resource_spec, "num_slices", 1) or 1)

    def _size(self, axis: str) -> int:
        shape = getattr(self.mesh, "shape", None) or {}
        return int(shape.get(axis, 1))

    def _model_axis(self) -> Optional[str]:
        return MESH_AXIS_MODEL if self._size(MESH_AXIS_MODEL) > 1 else None

    def _partition_spec(self, var, axis: Optional[int],
                        mesh_axis: Optional[str]):
        """``(spec, pad)``: ``var``'s dim ``axis`` sharded over
        ``mesh_axis``; ``pad`` is ``(axis, padded dim)`` when the dim does
        not divide the axis, and the variable stays replicated (``()``,
        with the JAX warning) when padding would at least double it."""
        if axis is None or mesh_axis is None:
            return (), None
        size = self._size(mesh_axis)
        if size <= 1:
            return (), None
        entries: List[Optional[str]] = [None] * len(var.shape)
        entries[axis] = mesh_axis
        spec = spec_from_entries(entries)
        dim = var.shape[axis]
        if dim % size:
            padded = -(-dim // size) * size
            if padded >= 2 * dim:
                _warn_once(
                    "variable %s dim %d (size %d) would pad to %d on the %r "
                    "axis (size %d) — more than doubling it; keeping it "
                    "replicated", var.name, axis, dim, padded, mesh_axis,
                    size)
                return (), None
            log.info("variable %s dim %d (size %d) padded to %d for even "
                     "%r-axis sharding", var.name, axis, dim, padded,
                     mesh_axis)
            return spec, (axis, padded)
        return spec, None

    def _wus_opt_spec(self, var, spec):
        """The weight-update-sharding layout: the largest unsharded dim
        that divides the data size, over ``data``; the parameter's layout
        otherwise."""
        d = self._size(MESH_AXIS_DATA)
        if d <= 1 or not var.shape:
            return spec
        entries = list(spec) + [None] * (len(var.shape) - len(spec))
        if MESH_AXIS_DATA in entries:
            return spec
        best, best_dim = None, 0
        for i, dim in enumerate(var.shape):
            if entries[i] is None and dim % d == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best is None:
            return spec
        entries[best] = MESH_AXIS_DATA
        return spec_from_entries(entries)

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
                # replicate + average, the expert stacking still applied
                spec = self._apply_structural_specs(var, ())
                plans[name] = VarPlan(var_name=name, param_spec=spec,
                                      opt_spec=spec)
        return CompiledStrategy(strategy=strategy, mesh=self.mesh,
                                var_plans=plans, num_slices=self.num_slices)

    def _structural_spec(self, var, spec, target: int, mesh_axis: str,
                         label: str):
        """``spec`` with dim ``target`` of ``var`` over ``mesh_axis`` when
        it divides the axis; otherwise ``spec`` as it is, with the JAX
        warning."""
        size = self._size(mesh_axis)
        if size <= 1 or len(var.shape) <= target:
            return spec
        if var.shape[target] % size:
            _warn_once(
                "%s variable %s dim %d (size %d) is not divisible by the %r "
                "axis (size %d); keeping it replicated", label, var.name,
                target, var.shape[target], mesh_axis, size)
            return spec
        entries = list(spec) + [None] * (len(var.shape) - len(spec))
        entries[target] = mesh_axis
        return spec_from_entries(entries)

    @staticmethod
    def _structural_axes(var) -> Tuple[int, ...]:
        """The dims the pipeline and expert stacking own (a strategy
        partitioner may not claim them): dim 0 of a ``pipeline_vars``
        stack, and the expert dim of an ``expert_vars`` stack (its
        leading dim, or the one after the stage dim)."""
        axes = []
        if var.pipeline:
            axes.append(0)
        if var.expert:
            axes.append(1 if var.pipeline else 0)
        return tuple(axes)

    def _apply_structural_specs(self, var, spec):
        """The stage stack's leading dim over ``pipe`` and the expert dim
        over ``expert``, after the synchronizer's lowering (so they
        compose with a ``model`` or ``data`` sharding of another dim)."""
        if var.pipeline:
            spec = self._structural_spec(var, spec, 0, MESH_AXIS_PIPE,
                                         "pipeline")
        if var.expert:
            spec = self._structural_spec(var, spec,
                                         1 if var.pipeline else 0,
                                         MESH_AXIS_EXPERT, "expert")
        return spec

    def _compile_node(self, node, var) -> VarPlan:
        axis, num_shards = parse_partitioner(node.partitioner)
        if axis in self._structural_axes(var):
            axis, num_shards = None, 1      # owned by the expert stacking
        if axis is not None and (len(var.shape) <= axis
                                 or var.shape[axis] < 2):
            raise ValueError(
                f"partitioner {node.partitioner!r} invalid for {var.name} "
                f"with shape {var.shape}")
        model_axis = self._model_axis()
        sync = node.synchronizer
        if isinstance(sync, PSSynchronizerConfig):
            shard_axis = model_axis or (MESH_AXIS_DATA if axis is not None
                                        else None)
            spec, pad = self._partition_spec(var, axis, shard_axis)
            sparse_shard = (var.sparse and axis is None and var.shape
                            and not (var.pipeline or var.expert))
            if sparse_shard:
                spec, pad = self._partition_spec(
                    var, 0, model_axis or MESH_AXIS_DATA)
            if var.pipeline or var.expert:
                # the structural dims over pipe/expert, then WUS fills a
                # free dim with data (a no-op when the spec carries it)
                spec = self._apply_structural_specs(var, spec)
                opt_spec = self._wus_opt_spec(var, spec)
            else:
                opt_spec = spec if spec else self._wus_opt_spec(var, spec)
            storage = None
            if model_axis is None:
                storage = 0 if sparse_shard else axis
            return VarPlan(
                var_name=var.name, sync_kind="PS",
                sync_mode=("all_reduce" if per_shard_spec(spec, pad)
                           else MODE_REDUCE_SCATTER),
                reduction_destination=sync.reduction_destination,
                partition_axis=axis, num_shards=num_shards,
                sparse=var.sparse, staleness=int(sync.staleness),
                local_replication=bool(sync.local_replication),
                storage_axis=storage,
                storage_dim=var.shape[storage] if storage is not None else 0,
                param_spec=spec, opt_spec=opt_spec,
                pad_axis=pad[0] if pad else None, pad_dim=pad[1] if pad else 0)
        if not isinstance(sync, AllReduceSynchronizerConfig):
            raise ValueError(f"node {node.var_name} has no synchronizer")
        spec, pad = self._partition_spec(var, axis, model_axis)
        spec = self._apply_structural_specs(var, spec)
        return VarPlan(
            var_name=var.name, compressor=sync.compressor, group=sync.group,
            fused=sync.fused, sync_mode=sync.sync or "all_reduce",
            bucket_bytes=int(sync.bucket_bytes or 0),
            overlap=sync.overlap or "auto", hier=bool(sync.hier),
            partition_axis=axis if model_axis else None,
            num_shards=num_shards if model_axis else 1, sparse=var.sparse,
            param_spec=spec, opt_spec=spec,
            pad_axis=pad[0] if pad else None, pad_dim=pad[1] if pad else 0)



def per_shard_spec(spec, pad) -> bool:
    """Does a PS plan's ``spec`` shard dims over ``model``, ``expert`` or
    ``pipe`` only, unpadded (one dim, or a stage stack's ``pipe`` dim
    and its ``expert`` dim)?  Its gradient is then an ``"all_reduce"`` of
    the shard over ``data`` (the bucketed step's per-shard tier) instead
    of a reduce-scatter."""
    axes = [a for a in spec if a is not None]
    rest = [a for a in axes if a != MESH_AXIS_PIPE]
    return (pad is None and bool(axes) and len(rest) <= 1
            and all(a in SHARD_AXES for a in axes))
