"""Sharding-legality pass: does the plan lower onto the mesh at all?

Port of the JAX package's ``analysis/legality.py``.  This pass owns the
*projection*: it mirrors the compiler's lowering rules symbolically over
``{axis: size}`` (no mesh, no devices), filling ``ctx.plans`` with
:class:`PlanLite` records that the later passes consume.  Given a
:class:`CompiledStrategy` it projects the compiled strategy's own
Strategy over the compiled mesh's axes (the port's compiler lowers a
Strategy node for node, so the projection is the lowered plan) and checks
that every compiled plan agrees with it.

The port lowers every axis of the JAX package's mesh (``pipe``, ``data``,
``expert``, ``seq``, ``model``), so the rules are the JAX pass's.

Rules (docs/analysis.md):

* ``legality/invalid-partitioner`` (ERROR) — unparseable partitioner,
  more than one active axis, axis beyond the variable's rank, or a
  dim < 2: the compiler raises ``ValueError`` on these mid-build.
* ``legality/indivisible-partition`` (ERROR) — a partitioned dim neither
  divides its mesh axis nor is covered by pad-to-divisible sharding
  (padding would at least double the variable, so the compiler silently
  replicates — the plan that runs is NOT the plan that was asked for).
* ``legality/padded-partition`` (INFO) — indivisible dim covered by the
  pad-to-divisible path (pad rows zero-masked each step).
* ``legality/unknown-mesh-axis`` (ERROR) — a spec names an axis the mesh
  does not carry (hand-built plans only; the projection cannot emit it).
* ``legality/duplicate-mesh-axis`` (ERROR) — one spec uses the same mesh
  axis on two tensor dims.
* ``legality/structural-axis-claimed`` (WARN) — a partitioner claims a
  pipeline/expert structural axis; the compiler drops the claim.
* ``legality/structural-indivisible`` (WARN) — a stage/expert stack dim
  not divisible by its mesh axis; the compiler keeps it replicated.
* ``legality/ar-partition-colocated`` (INFO) — an AllReduce partitioner
  on a mesh without a model axis: shards stay colocated with replicas
  (the reference layout), i.e. the partitioner is a no-op.
* ``legality/batch-axis-mismatch`` (ERROR) — compiled batch axes missing
  from the mesh, or a trainable plan whose gradient is NOT reduced over
  the data axis while the batch is sharded over it (silent divergence).
* ``legality/batch-indivisible`` (WARN) — a provided batch leaf whose
  leading dim does not divide the data axis (the step will replicate it).
* ``legality/mesh-hint-mismatch`` (WARN) — the strategy's
  ``graph_config.mesh_axes`` hint names axes the mesh does not carry.
* ``legality/zero1-fallback`` (WARN) — ``sync="reduce_scatter"`` (ZeRO-1)
  requested for a variable the bucketed path cannot absorb (partitioned,
  padded, or non-bucketable compressor); it falls back to a per-variable
  collective with replicated optimizer state.  Shares
  ``bucketing.bucket_drop_reason`` with the runtime.
* ``legality/slice-mismatch`` (ERROR) — the resource spec's ``num_slices``
  does not divide the mesh's device count: a two-tier topology would
  leave a ragged slice.  Shares ``resource_spec.slice_mismatch_reason``
  with the session-build fail-fast, so the CLI and ``AutoDist`` can
  never disagree.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from autodist_tpu_torch.analysis.analyzer import (
    AnalysisContext,
    PlanLite,
    register_pass,
)
from autodist_tpu_torch.analysis.diagnostics import Diagnostic, Severity, diag
from autodist_tpu_torch.const import (
    MESH_AXIS_DATA,
    MESH_AXIS_EXPERT,
    MESH_AXIS_MODEL,
    MESH_AXIS_PIPE,
)
from autodist_tpu_torch.graph_item import VarInfo


def _structural_axes(var: VarInfo) -> Tuple[int, ...]:
    axes = []
    if var.pipeline:
        axes.append(0)
    if var.expert:
        axes.append(1 if var.pipeline else 0)
    return tuple(axes)


def _partition(var: VarInfo, axis: Optional[int], target: Optional[str],
               mesh_axes: Dict[str, int], diags: List[Diagnostic]
               ) -> Tuple[Dict[int, str], Optional[Tuple[int, int]]]:
    """Mirror of ``StrategyCompiler._partition_spec`` over axis sizes."""
    if axis is None or target is None:
        return {}, None
    size = int(mesh_axes.get(target, 1))
    if size <= 1:
        return {}, None
    dim = var.shape[axis]
    if dim % size:
        padded = -(-dim // size) * size
        if padded >= 2 * dim:
            diags.append(diag(
                "legality/indivisible-partition", Severity.ERROR,
                f"dim {axis} (size {dim}) cannot shard over {target!r} "
                f"(size {size}): padding to {padded} would at least double "
                "the variable, so the compiler silently replicates it",
                var=var.name, location=f"dim{axis}->{target}",
                fix=f"use a dim divisible by {size}, shrink the {target!r} "
                    "axis, or drop the partitioner"))
            return {}, None
        diags.append(diag(
            "legality/padded-partition", Severity.INFO,
            f"dim {axis} (size {dim}) pads to {padded} for even {target!r} "
            "sharding (pad rows zero-masked each step)",
            var=var.name, location=f"dim{axis}->{target}"))
        return {axis: target}, (axis, padded)
    return {axis: target}, None


def _apply_structural(var: VarInfo, placement: Dict[int, str],
                      mesh_axes: Dict[str, int],
                      diags: List[Diagnostic]) -> None:
    """Mirror of ``_apply_structural_specs``: pipe on dim 0, expert on
    the next structural dim, when they divide."""
    def one(dim: int, axis_name: str, label: str) -> None:
        size = int(mesh_axes.get(axis_name, 1))
        if size <= 1 or len(var.shape) <= dim:
            return
        if var.shape[dim] % size:
            diags.append(diag(
                "legality/structural-indivisible", Severity.WARN,
                f"{label} dim {dim} (size {var.shape[dim]}) is not "
                f"divisible by the {axis_name!r} axis (size {size}); the "
                "compiler keeps it replicated",
                var=var.name, location=f"dim{dim}->{axis_name}",
                fix=f"make the {label} stack a multiple of {size}"))
            return
        placement[dim] = axis_name

    if var.pipeline:
        one(0, MESH_AXIS_PIPE, "pipeline")
    if var.expert:
        one(1 if var.pipeline else 0, MESH_AXIS_EXPERT, "expert")


def _wus_opt(var: VarInfo, placement: Dict[int, str],
             mesh_axes: Dict[str, int]) -> Dict[int, str]:
    """Mirror of ``_wus_opt_spec``: shard the largest free dim over
    ``data`` when it divides evenly."""
    d = int(mesh_axes.get(MESH_AXIS_DATA, 1))
    if d <= 1 or not var.shape:
        return dict(placement)
    if MESH_AXIS_DATA in placement.values():
        return dict(placement)
    best, best_dim = None, 0
    for i, dim in enumerate(var.shape):
        if i not in placement and dim % d == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best is None:
        return dict(placement)
    out = dict(placement)
    out[best] = MESH_AXIS_DATA
    return out


def _zero1_effective(mode: str, placement: Dict[int, str],
                     pad: Optional[Tuple[int, int]], compressor: str,
                     d: int, diags: List[Diagnostic],
                     var: VarInfo) -> bool:
    """Does the requested ``sync="reduce_scatter"`` actually shard this
    var's weight update?  Shares the bucket-eligibility rule with the
    runtime (``bucketing.bucket_drop_reason``) so the lint cannot drift;
    emits the fallback WARN the explicit path logs at trace time."""
    if mode != "reduce_scatter" or d <= 1:
        return False
    from autodist_tpu_torch.kernel.synchronization.bucketing import (
        bucket_drop_reason,
    )
    why = bucket_drop_reason(sorted(placement.items()), pad is not None,
                             compressor or "NoneCompressor")
    if why is None:
        return True
    diags.append(diag(
        "legality/zero1-fallback", Severity.WARN,
        f"sync='reduce_scatter' requested but this variable cannot join "
        f"a flat gradient bucket ({why}); it falls back to its "
        "per-variable/per-shard collective with replicated optimizer "
        "state",
        var=var.name,
        fix="drop the partitioner or use a bucketable compressor"))
    return False


def _lower_from_strategy(ctx: AnalysisContext
                         ) -> Tuple[Dict[str, PlanLite], List[Diagnostic]]:
    from autodist_tpu_torch.strategy.base import (
        AllReduceSynchronizerConfig,
        PSSynchronizerConfig,
    )
    from autodist_tpu_torch.strategy.compiler import parse_partitioner

    diags: List[Diagnostic] = []
    axes = ctx.axes
    gi = ctx.graph_item
    known = {v.name: v for v in gi.info.variables}
    model_axis = MESH_AXIS_MODEL \
        if int(axes.get(MESH_AXIS_MODEL, 1)) > 1 else None
    d = int(axes.get(MESH_AXIS_DATA, 1))
    grad_axes = (MESH_AXIS_DATA,) if d > 1 else ()
    plans: Dict[str, PlanLite] = {}

    for node in ctx.strategy.node_config:
        var = known.get(node.var_name)
        if var is None or not var.trainable:
            continue  # dead / frozen nodes: the sync pass reports them
        try:
            axis, num_shards = parse_partitioner(node.partitioner)
        except ValueError as e:
            diags.append(diag(
                "legality/invalid-partitioner", Severity.ERROR, str(e),
                var=var.name, location=node.partitioner,
                fix="use one active axis, e.g. \"1,4,1\""))
            axis, num_shards = None, 1
        if axis is not None and axis in _structural_axes(var):
            diags.append(diag(
                "legality/structural-axis-claimed", Severity.WARN,
                f"partitioner {node.partitioner!r} claims structural dim "
                f"{axis} (owned by the pipe/expert stacking); the compiler "
                "drops the claim",
                var=var.name, location=f"dim{axis}",
                fix="partition a non-structural dim"))
            axis = None
        if axis is not None and (len(var.shape) <= axis
                                 or var.shape[axis] < 2):
            diags.append(diag(
                "legality/invalid-partitioner", Severity.ERROR,
                f"partitioner {node.partitioner!r} is invalid for shape "
                f"{var.shape}: the compiler raises on it",
                var=var.name, location=node.partitioner,
                fix="partition an existing dim of size >= 2"))
            axis = None

        sync = node.synchronizer
        if isinstance(sync, AllReduceSynchronizerConfig):
            placement: Dict[int, str] = {}
            pad = None
            if axis is not None:
                if model_axis is None:
                    diags.append(diag(
                        "legality/ar-partition-colocated", Severity.INFO,
                        f"AllReduce partitioner {node.partitioner!r} on a "
                        "mesh with no model axis: shards stay colocated "
                        "with replicas (the partitioner is a layout no-op)",
                        var=var.name, location=node.partitioner))
                else:
                    placement, pad = _partition(var, axis, model_axis,
                                                axes, diags)
            _apply_structural(var, placement, axes, diags)
            mode = getattr(sync, "sync", "all_reduce") or "all_reduce"
            plans[var.name] = PlanLite(
                var=var, sync_kind="AllReduce", placement=placement,
                opt_placement=dict(placement), pad=pad,
                compressor=sync.compressor or "NoneCompressor",
                fused=bool(getattr(sync, "fused", False)), group=sync.group,
                grad_reduce_axes=grad_axes,
                sync_mode=mode,
                zero1=_zero1_effective(mode, placement, pad,
                                       sync.compressor, d, diags, var),
                bucket_bytes=int(getattr(sync, "bucket_bytes", 0) or 0),
                overlap=getattr(sync, "overlap", "auto") or "auto",
                hier=bool(getattr(sync, "hier", False)))
        elif isinstance(sync, PSSynchronizerConfig):
            shard_axis = model_axis or (
                MESH_AXIS_DATA if axis is not None else None)
            placement, pad = _partition(var, axis, shard_axis, axes, diags)
            if (var.sparse and axis is None and var.shape
                    and not (var.pipeline or var.expert)):
                placement, pad = _partition(
                    var, 0, model_axis or MESH_AXIS_DATA, axes, diags)
            if var.pipeline or var.expert:
                _apply_structural(var, placement, axes, diags)
                opt = _wus_opt(var, placement, axes)
            else:
                opt = dict(placement) if placement \
                    else _wus_opt(var, placement, axes)
            plans[var.name] = PlanLite(
                var=var, sync_kind="PS", placement=placement,
                opt_placement=opt, pad=pad, staleness=sync.staleness,
                grad_reduce_axes=grad_axes)
        # nodes with no/unknown synchronizer: the sync pass errors on them

    for name, var in known.items():
        if name in plans:
            continue
        if var.trainable:
            placement = {}
            _apply_structural(var, placement, axes, diags)
            plans[name] = PlanLite(
                var=var, sync_kind="AllReduce", placement=placement,
                opt_placement=dict(placement), grad_reduce_axes=grad_axes,
                synthesized=True)
        else:
            plans[name] = PlanLite(var=var, sync_kind=None)
    return plans, diags


def _lower_from_compiled(ctx: AnalysisContext
                         ) -> Tuple[Dict[str, PlanLite], List[Diagnostic]]:
    """The compiled strategy's Strategy projected over the compiled
    mesh's axes, each compiled plan checked against its projection: a
    plan that names a variable the catalog lacks, or whose sync kind,
    compressor, mode or storage differs from what its node asks for,
    was built by hand and is reported."""
    from autodist_tpu_torch.strategy.compiler import per_shard_spec

    plans, diags = _lower_from_strategy(ctx)
    known = {v.name for v in ctx.graph_item.info.variables}
    d = int(ctx.axes.get(MESH_AXIS_DATA, 1))
    for name, vp in ctx.compiled.var_plans.items():
        if name not in known:
            diags.append(diag(
                "legality/unknown-mesh-axis", Severity.WARN,
                "compiled plan names a variable absent from the program "
                "catalog", var=name,
                fix="rebuild the plan against the current GraphItem"))
            continue
        lite = plans.get(name)
        if lite is None:
            continue
        placement = {i: e for i, e in enumerate(vp.param_spec or ())
                     if e is not None}
        if not placement and d > 1 and vp.storage_axis is not None \
                and vp.stored_at(d):
            placement = {vp.storage_axis: MESH_AXIS_DATA}
        # PS plans shard their update over data, but a variable sharded
        # over model or expert alone, or over pipe (and expert), unpadded,
        # reduces its shard on the per-shard tier
        per_shard = per_shard_spec(tuple(placement.values()), lite.pad)
        want_mode = "reduce_scatter" if lite.sync_kind == "PS" \
            and not per_shard else lite.sync_mode
        if (vp.sync_kind != lite.sync_kind
                or (vp.compressor or "NoneCompressor") != lite.compressor
                or (vp.sync_mode or "all_reduce") != want_mode
                or placement != lite.placement):
            diags.append(diag(
                "legality/indivisible-partition", Severity.ERROR,
                "the compiled plan is not the plan its strategy node "
                "asks for: the plan that runs is not the plan that was "
                "asked for",
                var=name, fix="rebuild the plan from the strategy"))
    return plans, diags


def _check_batch_layout(ctx: AnalysisContext) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    d = ctx.data_axis_size
    if ctx.compiled is not None and getattr(ctx.compiled, "batch_axes",
                                             None) is not None:
        for ax in ctx.compiled.batch_axes:
            if ax not in ctx.axes:
                diags.append(diag(
                    "legality/batch-axis-mismatch", Severity.ERROR,
                    f"batch_axes names mesh axis {ax!r}; the mesh carries "
                    f"{sorted(ctx.axes)}", location=str(ax)))
        if d > 1 and MESH_AXIS_DATA in ctx.compiled.batch_axes:
            for name, plan in ctx.plans.items():
                if (plan.sync_kind is not None and not plan.synthesized
                        and MESH_AXIS_DATA not in plan.grad_reduce_axes):
                    diags.append(diag(
                        "legality/batch-axis-mismatch", Severity.ERROR,
                        "batch is sharded over 'data' but this plan never "
                        "reduces its gradient over 'data': replicas would "
                        "silently diverge", var=name,
                        fix="add 'data' to grad_reduce_axes"))
        elif d > 1 and MESH_AXIS_DATA not in ctx.compiled.batch_axes:
            diags.append(diag(
                "legality/batch-axis-mismatch", Severity.WARN,
                f"mesh has a data axis of size {d} but the batch is not "
                "sharded over it: every chip computes the full batch",
                fix="set batch_axes=('data',) or drop the data axis"))
    if ctx.batch is not None and d > 1:
        from autodist_tpu_torch.graph_item import flatten
        leaves = [x for _, x in flatten(ctx.batch)] \
            if isinstance(ctx.batch, dict) else (
                list(ctx.batch) if isinstance(ctx.batch, (list, tuple))
                else [ctx.batch])
        for leaf in leaves:
            shape = tuple(getattr(leaf, "shape", ()) or ())
            if shape and shape[0] % d:
                diags.append(diag(
                    "legality/batch-indivisible", Severity.WARN,
                    f"batch leaf with leading dim {shape[0]} does not "
                    f"divide the data axis (size {d}); it will be "
                    "replicated on every chip",
                    location=f"batch[{shape}]",
                    fix=f"pad the global batch to a multiple of {d}"))
                break  # one finding is enough; the step warns per leaf
    return diags


def _check_mesh_hint(ctx: AnalysisContext) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    hint = getattr(ctx.strategy.graph_config, "mesh_axes", None) or {}
    for name, size in hint.items():
        if name not in ctx.axes:
            diags.append(diag(
                "legality/mesh-hint-mismatch", Severity.WARN,
                f"strategy mesh hint names axis {name!r} (size {size}) "
                f"but the mesh carries {sorted(ctx.axes)}",
                location=str(name)))
    return diags


def _stamp_numerics(ctx: AnalysisContext, plans) -> None:
    """Project the program-level numerics config onto each plan: is the
    fused guard active for this variable's sync, and what loss scale
    rides its gradient?  Shares the runtime's exact resolution
    (``numerics.loss_scale.resolve_loss_scale``) so the ``numerics/*``
    precision rules can never drift from what the step would build."""
    cfg = getattr(ctx.graph_item, "numerics", None)
    if cfg is None or not cfg.guard:
        return
    from autodist_tpu_torch.numerics.loss_scale import resolve_loss_scale

    dtypes = [str(p.var.dtype) for p in plans.values()]
    ls = resolve_loss_scale(cfg.loss_scale, dtypes)
    peak = 0.0 if ls is None else (ls.max_scale if ls.dynamic else ls.init)
    for plan in plans.values():
        if plan.sync_kind is not None:
            plan.guard = True
            plan.loss_scale = float(peak)


def _check_slices(ctx: AnalysisContext) -> List[Diagnostic]:
    """The ``legality/slice-mismatch`` rule: a multi-slice spec whose
    slice count cannot tile this mesh's device count.  Same pure rule
    (``slice_mismatch_reason``) as the ``ResourceSpec`` fail-fast —
    here it additionally catches spec-vs-mesh drift (a spec validated
    against its own chip count, analyzed against different axes)."""
    from autodist_tpu_torch.resource_spec import slice_mismatch_reason

    spec = ctx.resource_spec
    if spec is None:
        return []
    s = int(getattr(spec, "num_slices", 1) or 1)
    total = 1
    for size in ctx.axes.values():
        total *= max(int(size), 1)
    reason = slice_mismatch_reason(total, s)
    if reason is None:
        return []
    return [diag(
        "legality/slice-mismatch", Severity.ERROR, reason,
        location=f"axes={dict(ctx.axes)}",
        fix="pick a num_slices that divides the device count, or "
            "resize the mesh to a multiple of the slice count")]


@register_pass("legality")
def run(ctx: AnalysisContext) -> List[Diagnostic]:
    if ctx.compiled is not None:
        plans, diags = _lower_from_compiled(ctx)
    else:
        plans, diags = _lower_from_strategy(ctx)
    _stamp_numerics(ctx, plans)
    ctx.plans = plans
    diags += _check_batch_layout(ctx)
    diags += _check_mesh_hint(ctx)
    diags += _check_slices(ctx)
    return diags
