"""The explicit bucketed training step, for all-reduce and ZeRO-1 buckets.

Port of the JAX package's ``kernel/synchronization/explicit_sync.py``.
Reduce-scatter (ZeRO-1) buckets hold the variables of ``Zero1`` plans and
of every PS plan: the PS family's weight-update sharding, which the JAX
package lowers through GSPMD (``graph_transformer.py:428-470``), runs
here as the same reduce-scatter → 1/N shard update → all-gather.  One
step may mix both kinds (``Parallax``: the embedding's PS plan in a
reduce-scatter bucket, the dense variables' AllReduce plans in
all-reduce buckets).  The step runs, on each rank, in order:

0. at data size > 1, the compute copy of the variables stored 1/N
   (``CompiledStrategy.stored_vars``: their buckets are ``stored``):
   each such bucket's chunk, the only copy a rank keeps between steps, is
   all-gathered (``overlap.gather_schedule(..., at_start=True)`` order)
   and unpacked into transient full tensors; they are dropped once the
   backward has produced the gradients;
1. loss and gradients on this rank's rows of the global batch (inside
   :func:`~autodist_tpu_torch.mesh.data_rows`), the loss multiplied by
   the loss scale first when one is on; with ``accum_steps > 1`` the
   microbatches accumulate inside the step, or, for the buckets the
   accumulation pipeline takes (``overlap.pipeline_eligible``), run
   through :func:`~.overlap.pipelined_accumulate`: each microbatch's
   buckets reduce while the next microbatch's backward runs;
2. the per-variable tier: a variable whose compressor does not compose
   with flat buckets (``PowerSGDCompressor``: its factors need the 2-D
   gradient) reduces through its compressor's ``reduce`` with its state
   under its name in the sync state (a ZeRO-1 request falls back to it,
   with the JAX package's warning, and to the tree update);
3. per bucket of :func:`plan_step_buckets`' plan: pack, then the
   reduction over the data group under the bucket's lowering, read from
   the bucket's node in the step's schedule IR (:func:`plan_step`: the
   IR is built from the bucket plan and the overlap plan and verified by
   ``schedule_ir.assert_verified`` before the step exists; no collective
   at data size 1):

   * an uncompressed bucket through ``overlap.bucket_reduce_fn`` (the
     backend's ``all_reduce`` / ``reduce_scatter``, whatever its label),
     or, when every member's plan asks for ``hier`` and
     ``overlap.hier_applies(d, num_slices)``, through the two-tier
     ``overlap.hier_bucket_reduce_fn`` (its cross-slice leg on the int8
     wire under ``AUTODIST_DCN_WIRE=int8``);
   * a cast bucket (``HorovodCompressor``, ``HorovodCompressorEF``)
     through its compressor's ``reduce`` / ``reduce_scatter``: bf16 on
     the wire, the EF residual (``padded_total`` long) under the bucket
     key;
   * a quantized bucket (``Int8Compressor``, ``Fp8Compressor``) through
     its compressor's ``bucket_reduce`` / ``bucket_reduce_scatter``: the
     quantized ring under explicit ``"ring"`` / ``"full"`` at 256 KiB and
     above, its hop boundaries through K6–K8 (``quant_ring``), else the
     one-shot ``all_to_all``; the error-feedback residual (this rank's
     ``padded_total`` vector in the sync state, under the bucket key) is
     added before quantization and replaced by the new one;
4. with ``capture(numerics=...)``, the guard: each bucket's finiteness
   from its packed local vector and its squared-norm partial from the
   reduced value, both by K4
   (:func:`~autodist_tpu_torch.ops.fused_kernels.fused_detect_stats`),
   a cast wire's saturation flag and a quantized bucket's saturation
   count, rolled into one :class:`~autodist_tpu_torch.numerics.
   GradHealth` by ONE all_reduce; the clip multiplier is ``inv_scale x
   clip``;
5. the skip gate: ``all_finite`` is read on the host once, before any
   update (the step updates in place, so the JAX package's select between
   the updated and the old state would cost a full copy of both).  A
   non-finite step updates nothing: params, optimizer state, ZeRO-1
   shards and compressor states stay bit-identical; the loss-scale state
   still moves and ``skipped_steps`` counts the skip;
6. with bounded staleness (PS ``staleness``) each stale bucket's reduced
   shard goes through its delay queue (:mod:`.stale_sync`), and the
   shard that comes out is applied;
7. the ZeRO-1 update of this rank's 1/N shard of each bucket (under
   ``hier`` the global chunk ``overlap.hier_owner`` names): K5
   (:func:`~autodist_tpu_torch.ops.fused_kernels.fused_adam_update`) when
   the optimizer is ``fusable_adam``, its state Adam-shaped and the
   buckets f32; otherwise the optimizer's own update on the shards, with
   the drop reason in a warning.  This is decided from the configuration
   when the step is built;
8. the tree update of every other variable (the all-reduce buckets'
   members, the per-variable tier and anything unbucketed), then the
   ``all_gather`` of each updated shard in ``overlap.gather_schedule``
   order (the two-tier gather for a ``hier`` bucket) and the unpack into
   the parameters; a stored bucket keeps its updated chunk and gathers
   at the start of the next step instead (step 0: the same collective
   and bytes, moved); a bucket of proxy variables keeps its true shard in
   the sync state and gathers only on refresh steps;
9. metrics: ``loss`` averaged over the data group and unscaled,
   ``grad_health``, ``aux`` averaged, the ``metrics_fn`` extras.

Optimizer state: without ZeRO-1 buckets, the tree state of the plain step;
with them, ``{"vars": tree state of the other variables, "zero1": the
optimizer's state over {bucket key: this rank's shard}}``, so each rank
holds 1/N of every bucket's moments.

Parameter storage: the step's parameter tree holds, for a member of a
stored bucket at data size > 1, this rank's part of the bucket's chunk
as a 1-D tensor (:func:`~.bucketing.member_spans`; empty where the
member lies outside the chunk), and the replicated value for every other
variable.  ``place_params``/``shard_params`` cut logical values to it,
``export_params`` gathers it back (a collective: every rank calls it;
the session evaluates on what it gives).  A proxied bucket keeps the
JAX package's rule for a proxy: its compute copy is the replicated
mirror, its true shard in the sync state.

Two rules of the JAX package's lowering are kept as they are: at data
size > 1 a strategy that takes the JAX explicit path (a compressor, an
AllReduce plan's ``reduce_scatter``, ``bucket_bytes``, an explicit
schedule, ``hier``, fused groups) together with staleness or proxies
runs fully synchronously, with the JAX warning
(``graph_transformer.py:234-243``); and a stale or proxy step turns the
numerics guard off, with the JAX warning (``:334-339``), so K4 does not
launch there.

Differences from the JAX package, none of which changes a result: PS
plans run here, so their buckets are reduce-scatter bucket nodes of the
IR where the JAX package's GSPMD step has per-variable ``ps_exchange``
legs; an uncompressed bucket
labelled ``"ring"`` or ``"one_shot"`` reduces, and a ZeRO-1 shard
gathers, through the backend's collective, not as ring hops (the same
sum up to its last bits); buckets reduce in ``assign_buckets``' order;
the step runs at every data size, where the JAX package takes its GSPMD
step at size 1 (there every compressor but the quantized wire returns
the gradient as it is, and staleness applies); the quantized ring's hop
kernels run whenever a bucket is quantized (the JAX package's are an
opt-in; both put the same bits on the wire).  The port's mesh has only
the data axis (P10), so no variable keeps a per-shard collective
(:func:`partition_drop_reason` gives the JAX rule).  Under
``AUTODIST_FLIGHTREC=legs`` the step stamps a leg cursor where the JAX
package's stamps one (:func:`leg_stamp_points`: each bucket's reduce, the
guard roll-up, the ZeRO-1 or tree update, each parameter gather, a
pipelined bucket's reduce per microbatch slot), stream-ordered on the
card (``ops/leg_cursor.py``).  A stored variable lives in its flat bucket: a rank
holds its chunk of the bucket vector where the JAX package holds its
slice of the variable along the storage axis (``param_spec =
P("data")``), the flat bucket padded where JAX pads the dim.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from autodist_tpu_torch.const import ENV, MESH_AXIS_DATA
from autodist_tpu_torch.graph_item import flatten, tree_map, unflatten
from autodist_tpu_torch.kernel import graph_transformer as gt
from autodist_tpu_torch.kernel.synchronization import collectives as coll
from autodist_tpu_torch.kernel.synchronization import overlap as ov_mod
from autodist_tpu_torch.kernel.synchronization import quant_ring
from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
from autodist_tpu_torch.kernel.synchronization import stale_sync
from autodist_tpu_torch.kernel.synchronization.bucketing import (
    DEFAULT_BUCKET_BYTES, MODE_ALL_REDUCE, MODE_REDUCE_SCATTER, Bucket,
    assign_buckets, bucket_drop_reason, member_spans, pack_bucket,
    unpack_bucket)
from autodist_tpu_torch.kernel.synchronization.compressor import (
    Compressor, get_compressor)
from autodist_tpu_torch.mesh import data_rows
from autodist_tpu_torch.numerics import guard as guard_mod
from autodist_tpu_torch.numerics import loss_scale as ls_mod
from autodist_tpu_torch.numerics.guard import NUMERICS_KEY
from autodist_tpu_torch.ops import fused_kernels as fk
from autodist_tpu_torch.telemetry import flightrec
from autodist_tpu_torch.telemetry.timeline import sync_span


def _explicit_reason(plan) -> bool:
    return (plan.compressor not in ("", "NoneCompressor")
            or plan.sync_mode == MODE_REDUCE_SCATTER or bool(plan.bucket_bytes)
            or plan.overlap in (ov_mod.OVERLAP_PIPELINE, ov_mod.OVERLAP_RING,
                                ov_mod.OVERLAP_FULL)
            or plan.hier)


def uses_explicit_path(compiled, skip_ps: bool = False) -> bool:
    """Does the plan need the explicit bucketed step?  A compressor,
    ZeRO-1 (``reduce_scatter``), a non-zero ``bucket_bytes``, an explicit
    ``pipeline``/``ring``/``full`` schedule, ``hier``, and fused groups
    with a group to fuse do.  ``skip_ps``: would the JAX package lower
    the plan on its explicit path (it runs PS plans on its GSPMD step, so
    they give no reason)?"""
    if any(_explicit_reason(plan) for plan in compiled.var_plans.values()
           if not (skip_ps and plan.sync_kind == "PS")):
        return True
    return (any(plan.fused for plan in compiled.var_plans.values())
            and bool(compiled.fusable_groups()))


def chaos_grad_events_probe():
    """The ``nan_grad``/``inf_grad`` chaos events for this process, or []
    when none apply or the spec does not parse — probed so a gradient
    injection requested without the numerics guard warns instead of
    silently never firing."""
    try:
        from autodist_tpu_torch.resilience import chaos as chaos_mod
        return chaos_mod.grad_injections()
    except Exception:  # noqa: BLE001 - a malformed spec is not an error here
        return []


def _grad_shaped_state(comp: Compressor, shape: tuple, dtype) -> bool:
    """Is ``comp``'s per-rank state for a value of ``shape`` None or one
    tensor of exactly that shape and dtype?  Probed on a meta tensor."""
    probe = comp.init_state(torch.zeros(shape, dtype=dtype, device="meta"))
    if probe is None:
        return True
    leaves = [x for _, x in flatten(probe)] if isinstance(probe, dict) \
        else [probe]
    return (len(leaves) == 1 and tuple(leaves[0].shape) == tuple(shape)
            and leaves[0].dtype == dtype)


def partition_drop_reason(spec_axes, shape, dtype, axis_sizes, padded,
                          comp: Compressor) -> Optional[str]:
    """Why the explicit path drops a partitioned variable's sharding, or
    None when the partitioning is kept (the JAX package's rule).
    ``spec_axes`` is ``[(tensor_dim, mesh_axis_name), ...]`` of the
    layout, ``axis_sizes`` maps axis name → size."""
    spec_axes = list(spec_axes)
    if not spec_axes:
        return None
    if padded:
        return "pad-to-divisible sharding"
    if len(spec_axes) != 1:
        return f"multi-axis sharding {spec_axes}"
    part_axis, axis_name = spec_axes[0]
    if axis_name == MESH_AXIS_DATA:
        return "sharded over the data (reduction) axis"
    n = int(axis_sizes.get(axis_name, 1))
    if n > 1 and shape[part_axis] % n:
        return f"dim {shape[part_axis]} not divisible by {n}"
    shard = list(shape)
    if n > 1:
        shard[part_axis] //= n
    if not _grad_shaped_state(comp, tuple(shard), dtype):
        return (f"{comp.name} state is not grad-shaped"
                f" (e.g. PowerSGD low-rank factors)")
    return None


def plan_step_buckets(gi, compiled, d: int) -> List[Bucket]:
    """The step's buckets: every synced variable whose compressor composes
    with flat buckets, in catalog order, keyed by (mode, dtype,
    compressor, group), capped by the largest ``bucket_bytes`` of the
    plans and padded to a multiple of the data size ``d``; the variables
    stored 1/N fill buckets of their own (``Bucket.stored``), at ``d`` 1
    too, where nothing is sharded, so that a checkpoint's bucket layout
    does not depend on the data size (but for a variable the JAX rule
    keeps replicated at ``d``, ``VarPlan.stored_at``)."""
    entries = []
    cap = 0
    for v in gi.info.variables:
        plan = compiled.var_plans.get(v.name)
        if plan is None:
            continue
        comp = plan.compressor or "NoneCompressor"
        if bucket_drop_reason((), False, comp) is not None:
            continue
        mode = plan.sync_mode or MODE_ALL_REDUCE
        entries.append((v.name, v.shape, v.dtype, comp, plan.group, mode,
                        mode == MODE_REDUCE_SCATTER
                        and plan.stored_at(d)))
        cap = max(cap, plan.bucket_bytes)
    return assign_buckets(entries, bucket_bytes=cap or DEFAULT_BUCKET_BYTES,
                          shard_divisor=max(d, 1))


def _mean_over(x: torch.Tensor, d: int, group) -> torch.Tensor:
    if d == 1:
        return x
    return coll.all_reduce(x, group) / d


def stale_step(compiled) -> bool:
    """Does the step run bounded staleness or proxies?  Not when the
    strategy also takes the JAX package's explicit path at data size > 1
    (it then runs fully synchronously, with the JAX warning)."""
    d = compiled.mesh.data_size
    return stale_sync.uses_stale_path(compiled) and not (
        d > 1 and uses_explicit_path(compiled, skip_ps=True))


def _meta_state(comp: Compressor, shape, dtype: str):
    return comp.init_state(torch.empty(tuple(shape), device="meta",
                                       dtype=getattr(torch, dtype)))


@dataclass
class StepPlan:
    """What the bucketed step is built from, decided before it is built:
    the buckets, the overlap plan, the fused kernels it runs (and those
    it drops, with the reason), whether the guard is on, and the
    schedule IR of it all, from which the step takes each bucket's
    lowering."""

    buckets: List[Bucket]
    overlap: Any
    fused_kernels: Tuple[str, ...]
    fused_drops: List[Tuple[str, str]]
    guard: bool
    ir: Any


def plan_step(gi, compiled) -> StepPlan:
    """The explicit step's plan, pure (no collective, no memory): the same
    inputs as the JAX package's ``make_explicit_step`` gives
    ``schedule_ir.build_schedule_ir`` (``explicit_sync.py:488-523``),
    from this port's bucket plan."""
    d = compiled.mesh.data_size
    plans = compiled.var_plans
    buckets = plan_step_buckets(gi, compiled, d)
    bucketed = {n for b in buckets for n in b.names}
    rs_buckets = [b for b in buckets if b.mode == MODE_REDUCE_SCATTER]
    num_slices = int(getattr(compiled, "num_slices", 1) or 1)
    hier_keys = [b.key for b in buckets
                 if ov_mod.hier_applies(d, num_slices) and b.names
                 and all(plans[n].hier for n in b.names)]
    ov = ov_mod.resolve_overlap(
        [plan.overlap for plan in plans.values()],
        accum_steps=gi.accum_steps, buckets=buckets, d=d,
        has_rs=bool(rs_buckets))
    num_cfg = gi.numerics
    guard = bool(num_cfg is not None and num_cfg.guard) \
        and not stale_step(compiled)
    spec = getattr(gi.optimizer, "fused_spec", None)
    adam_shaped = True
    if spec is not None and rs_buckets:
        adam_shaped = fk.find_adam_state(
            gi.optimizer.init({"x": torch.zeros(8)})) is not None
    active, drops = fk.resolve_fused(
        guard=guard, has_rs=bool(rs_buckets),
        has_quant_ring=any(quant_ring.is_quant_ring_compressor(b.compressor)
                           for b in buckets),
        optimizer_fusable=spec is not None, adam_state_shaped=adam_shaped,
        f32_buckets=all(b.dtype == "float32" for b in rs_buckets))

    # sync state: the stateful per-variable entries, buckets, numerics
    infos = {v.name: v for v in gi.info.variables}
    stateful_vars = [v.name for v in gi.info.variables
                     if v.trainable and v.name in plans
                     and v.name not in bucketed
                     and _meta_state(get_compressor(plans[v.name].compressor),
                                     v.shape, v.dtype) is not None]
    stateful_buckets = [b.key for b in buckets if _meta_state(
        get_compressor(b.compressor), (b.padded_total,), b.dtype) is not None]
    sync_keys = stateful_vars + stateful_buckets \
        + ([NUMERICS_KEY] if guard else [])
    per_var = [sir.PerVarEntry(
        name=n, dtype=infos[n].dtype, nbytes=infos[n].byte_size,
        sync_kind="AllReduce",
        compressor=plan.compressor or "NoneCompressor",
        sig=sir.fact_from_varplan(plan, infos[n], d).sig(),
        stateful=n in stateful_vars)
        for n, plan in plans.items()
        if n not in bucketed and n in infos and infos[n].trainable]
    axes = {str(a): int(n) for a, n in compiled.mesh.shape.items()}
    ir = sir.build_schedule_ir(
        axes=axes, accum_steps=gi.accum_steps, buckets=buckets, plan=ov,
        num_slices=num_slices, hier_keys=hier_keys, per_var=per_var,
        guard=guard,
        donated=tuple(f"sync:{k}" for k in sync_keys)
        if not stateful_vars else (),
        stateful_keys=set(stateful_buckets), fused_kernels=active,
        moe=sir.moe_facts_from_vars(gi.info.variables, axes=axes))
    return StepPlan(buckets=buckets, overlap=ov, fused_kernels=active,
                    fused_drops=drops, guard=guard, ir=ir)


def leg_stamp_points(ir) -> Dict[str, Dict[str, Tuple[str, str]]]:
    """Where the step stamps leg cursors, under the IR's leg ids (the JAX
    package's ``explicit_sync.py:538-564``): ``{"reduce": {bucket key:
    (leg id, kind)}, "update": {bucket key or "~tree": ...}, "gather":
    {bucket key: ...}}``.  A bucket's reduce is its last leg that writes
    the reduced value (a pipelined bucket's first, as a ``{slot}``
    template); its gather the last ``@gather`` leg that writes its
    parameters."""
    import re

    pipe = ir.pipelined_keys()
    reduce: Dict[str, Tuple[str, str]] = {}
    update: Dict[str, Tuple[str, str]] = {}
    gather: Dict[str, Tuple[str, str]] = {}
    for node in ir.buckets:
        key = node["key"]
        finals = [leg for leg in ir.legs
                  if leg.bucket == key and f"red:{key}" in leg.writes]
        if finals and key in pipe:
            reduce[key] = (re.sub(r"@\d+/", "@{slot}/", finals[0].id),
                           finals[0].kind)
        elif finals:
            reduce[key] = (finals[-1].id, finals[-1].kind)
        gathers = [leg for leg in ir.legs
                   if leg.bucket == key and "@gather" in leg.id
                   and f"param:{key}" in leg.writes]
        if gathers:
            gather[key] = (gathers[-1].id, gathers[-1].kind)
    for leg in ir.legs:
        if leg.id.startswith("update/"):
            update[leg.bucket] = (leg.id, leg.kind)
    return {"reduce": reduce, "update": update, "gather": gather}


def stamped_legs(ir, rs_keys) -> List[str]:
    """The leg ids one step of an unpipelined schedule stamps, in order:
    each bucket's reduce (bucket order), the guard roll-up, the first
    reduce-scatter bucket's update (``rs_keys``; the tree update without
    any), then the gathers in the IR's gather order."""
    pts = leg_stamp_points(ir)
    out = [pts["reduce"][n["key"]][0] for n in ir.buckets
           if n["key"] in pts["reduce"]]
    if any(leg.id == "guard/rollup" for leg in ir.legs):
        out.append("guard/rollup")
    first = rs_keys[0] if rs_keys else "~tree"
    if first in pts["update"]:
        out.append(pts["update"][first][0])
    out += [pts["gather"][k][0] for k, _ in ir.gather_plan()
            if k in pts["gather"]]
    return out


def make_explicit_step(gi, compiled, extra_metrics_fn=None
                       ) -> "gt.DistributedStep":
    """The explicit bucketed step of ``gi`` under ``compiled`` (see the
    module docstring), as a :class:`~autodist_tpu_torch.kernel.
    graph_transformer.DistributedStep`."""
    mesh = compiled.mesh
    d, group, rank = mesh.data_size, mesh.data_group, mesh.data_rank
    names = tuple(v.name for v in gi.info.trainable_variables)
    plans = compiled.var_plans
    # the plan and its schedule IR, verified before anything runs; each
    # bucket's lowering is read from the IR's bucket nodes
    sp = plan_step(gi, compiled)
    sir.assert_verified(sp.ir, "explicit sync build")
    ir = sp.ir
    buckets = sp.buckets
    bucketed = {n for b in buckets for n in b.names}
    rs_buckets = [b for b in buckets if b.mode == MODE_REDUCE_SCATTER]
    ar_buckets = [b for b in buckets if b.mode == MODE_ALL_REDUCE]
    rs_names = {n for b in rs_buckets for n in b.names}
    tree_names = tuple(n for n in names if n not in rs_names)
    optimizer, has_aux = gi.optimizer, gi.has_aux

    # -- the per-variable tier: non-bucketable compressors ------------------
    pervar = {n: get_compressor(plans[n].compressor) for n in names
              if n in plans and n not in bucketed}
    for n in pervar:
        if plans[n].sync_mode == MODE_REDUCE_SCATTER:
            warnings.warn(
                f"explicit sync path: {n} requested reduce_scatter (ZeRO-1) "
                "but cannot join a flat bucket (partitioned or "
                "non-bucketable compressor); falling back to its "
                "per-variable/per-shard collective with replicated "
                "optimizer state")

    # -- the two-tier hierarchy: every member opted in, and the axis factors -
    num_slices = int(getattr(compiled, "num_slices", 1) or 1)
    hier_keys = tuple(n["key"] for n in ir.buckets if n.get("hier"))
    within = across = None
    if hier_keys:
        within_lists, across_lists = ov_mod.hier_groups(d, num_slices)
        within = coll.subgroups(group, within_lists)
        across = coll.subgroups(group, across_lists)
    dcn_wire = quant_ring.wire_format_of(ENV.AUTODIST_DCN_WIRE.val)

    def owner(b: Bucket) -> int:
        """The chunk of ``b`` this rank's shard holds."""
        return ov_mod.hier_owner(rank, d, num_slices) \
            if b.key in hier_keys else rank

    def chunk_of(b: Bucket, vec: torch.Tensor) -> torch.Tensor:
        if d == 1:
            return vec
        sz = b.padded_total // d
        i = owner(b)
        return vec[i * sz:(i + 1) * sz]

    def gather_full(b: Bucket, shard: torch.Tensor) -> torch.Tensor:
        if d == 1:
            return shard
        if b.key in hier_keys:
            return ov_mod.hier_gather_fn(within, across)(shard)
        return coll.all_gather(shard, group)

    # -- the schedule: each bucket's lowering, from the IR's bucket nodes ----
    ov = sp.overlap
    for key, why in ov.drops:
        warnings.warn(f"explicit sync path: overlap scheduling skipped for "
                      f"bucket {key} ({why})")
    algs = {n["key"]: n["alg"] for n in ir.buckets}
    quant = {b.key: get_compressor(b.compressor) for b in buckets
             if quant_ring.is_quant_ring_compressor(b.compressor)}
    cast = {b.key: get_compressor(b.compressor) for b in buckets
            if b.key not in quant
            and not ov_mod.is_linear_compressor(b.compressor)}
    reduce_fns = {b.key: (ov_mod.hier_bucket_reduce_fn(
        b, within, across, rank, d, num_slices, dcn_wire=dcn_wire)
        if b.key in hier_keys else ov_mod.bucket_reduce_fn(b, group, d))
        for b in buckets if ov_mod.is_linear_compressor(b.compressor)}
    pipe_keys = ir.pipelined_keys()
    pipe = [b for b in buckets if b.key in pipe_keys]
    issue_fns = {b.key: (ov_mod.bucket_reduce_issue_fn(b, group, d)
                         if b.key not in hier_keys else
                         (lambda v, f=reduce_fns[b.key]: coll.done(f(v))))
                 for b in pipe if b.key in reduce_fns}
    by_key = {b.key: b for b in rs_buckets}
    gathers = [by_key[k] for k, _ in ir.gather_plan()]

    # -- flight-recorder leg cursors, resolved when the step is built -------
    legs_on = flightrec.trace_stamps_enabled()
    points = leg_stamp_points(ir) if legs_on \
        else {"reduce": {}, "update": {}, "gather": {}}

    def stamp(group: str, key: str, slot=None) -> None:
        if key in points[group]:
            lid, kind = points[group][key]
            flightrec.traced_stamp(lid, slot=slot, leg_kind=kind,
                                   device=mesh.device)

    # -- bounded staleness and proxies ----------------------------------------
    stale = None
    if stale_sync.uses_stale_path(compiled):
        if not stale_step(compiled):
            warnings.warn(
                "strategy requests bounded staleness / proxy variables AND "
                "gradient compression; the explicit compressor path runs "
                "fully synchronous — staleness/proxy settings are ignored")
        else:
            stale = stale_sync.StaleSync(compiled, rs_buckets, chunk_of,
                                         gather_full)
    proxied = set(stale.proxied_keys) if stale is not None else set()
    proxy_names = set(stale.proxied) if stale is not None else set()

    # -- 1/N parameter storage: the stored buckets, at data size > 1 --------
    stored = [b for b in rs_buckets
              if b.stored and d > 1 and b.key not in proxied]
    stored_keys = {b.key for b in stored}
    starts = ov_mod.gather_schedule(stored, ov.prefetch, at_start=True)
    trainable = set(names)

    def spans(b: Bucket):
        return member_spans(b, owner(b), b.padded_total // d)

    def stored_chunk(b: Bucket, leaves) -> torch.Tensor:
        """This rank's chunk of stored bucket ``b`` from its members'
        parts: the part itself when it fills the chunk, else a copy."""
        parts = [leaves[n].detach() for n in b.names]
        filled = [p for p in parts if p.numel()]
        sz = b.padded_total // d
        have = sum(p.numel() for p in filled)
        if len(filled) == 1 and have == sz:
            return filled[0]
        return torch.cat(filled + [parts[0].new_zeros(sz - have)])

    def write_parts(b: Bucket, leaves, chunk: torch.Tensor) -> None:
        """Copy an updated chunk into the members' parts (in place)."""
        pos = 0
        for n, (a, e) in zip(b.names, spans(b)):
            part = chunk[pos:pos + e - a]
            pos += e - a
            if part.numel() and part.data_ptr() != leaves[n].data_ptr():
                leaves[n].copy_(part)

    def shard_params(params):
        """``params`` (placed) with each stored member cut to this rank's
        part, a flat tensor that does not require grad; a leaf already
        cut is kept."""
        if not stored:
            return params
        leaves = dict(flatten(params))
        for b in stored:
            for n, v, (a, e) in zip(b.names, b.vars, spans(b)):
                x = leaves[n].detach().reshape(-1)
                if x.numel() == v.size:
                    x = x[a:e].clone()
                elif x.numel() != e - a:
                    raise ValueError(
                        f"{n}: {x.numel()} elements are neither the "
                        f"variable {v.shape} nor this rank's part "
                        f"({e - a} elements of bucket {b.key})")
                leaves[n] = x
        return unflatten([(n, leaves[n]) for n, _ in flatten(params)])

    def materialize(params, grad: bool = True, lend: bool = False):
        """The compute tree: each stored bucket gathered and unpacked into
        full tensors (trainable ones require grad when ``grad``); every
        other leaf as it is.  ``lend``: the stored parts borrow their
        values' storage in the gathered vector until :func:`reclaim`, so
        that a rank does not hold its chunk twice while the compute copy
        lives (the peak of the step)."""
        if not stored:
            return params
        leaves = dict(flatten(params))
        compute = dict(leaves)
        for b in starts:
            with sync_span(f"param_gather/{b.key}"):
                full = gather_full(b, stored_chunk(b, leaves))
            pos = owner(b) * (b.padded_total // d)
            for n, arr, (a, e) in zip(b.names, unpack_bucket(b, full),
                                      spans(b)):
                compute[n] = arr.detach().requires_grad_(grad
                                                         and n in trainable)
                if lend and e > a:
                    leaves[n].set_(full.untyped_storage(),
                                   full.storage_offset() + pos, (e - a,))
                pos += e - a
        return unflatten([(n, compute[n]) for n, _ in flatten(params)])

    def reclaim(params) -> None:
        """Give each stored part its own storage again (a copy out of the
        gathered vector :func:`materialize` lent it)."""
        leaves = dict(flatten(params))
        with torch.no_grad():
            for b in stored:
                for n in b.names:
                    leaves[n].set_(leaves[n].clone())

    # -- numerics guard: resolved when the step is built --------------------
    num_cfg = gi.numerics
    num_active = sp.guard
    if num_cfg is not None and num_cfg.guard and stale is not None:
        warnings.warn(
            "numerics guard disabled: bounded-staleness/proxy sync state "
            "owns the sync_state slot on this path; drop staleness or "
            "route through the explicit bucketed path")
    num_ls = None
    if num_active:
        num_ls = ls_mod.resolve_loss_scale(
            num_cfg.loss_scale,
            [v.dtype for v in gi.info.variables] + [b.dtype for b in buckets])
        for b in buckets:
            why = ls_mod.scale_saturates_wire(num_ls, b.compressor)
            if why is not None:
                raise ValueError(
                    f"numerics: bucket {b.key}: {why}; lower the loss scale "
                    "ceiling or drop the quantizing compressor")

    # -- the ZeRO-1 update's kernel: K5 unless the drop rule says not --------
    spec = getattr(optimizer, "fused_spec", None)
    active = sp.fused_kernels
    for kernel, why in sp.fused_drops:
        warnings.warn(f"explicit sync path: fused kernel {kernel} is not "
                      f"used, the ZeRO-1 shards take the unfused update "
                      f"({why})")
    update_fused = fk.KERNEL_UPDATE in active

    vg_unscaled = gt.scaled_value_and_grad(gi, names, None)
    # chaos nan_grad/inf_grad: on the device, keyed on the numerics
    # state's step counter (scale, then injection, then accumulation)
    inject = gt.chaos_injector(gi, num_active, buckets, names)

    def quant_reduce(b: Bucket, vec: torch.Tensor, state):
        """``(reduced, new residual, saturation count)`` of a quantized
        bucket under its lowering; a ring's hop boundaries run K6–K8."""
        comp = quant[b.key]
        fn = comp.bucket_reduce_scatter if b.mode == MODE_REDUCE_SCATTER \
            else comp.bucket_reduce
        return fn(vec, state, group, d, alg=algs[b.key])

    init_numerics = gt.sync_state_init(num_active, num_ls, mesh.device)

    # -- state ------------------------------------------------------------------
    def pack_params(leaves, b: Bucket) -> torch.Tensor:
        return pack_bucket(b, [leaves[n].detach() for n in b.names])

    def param_shards(leaves) -> Dict[str, torch.Tensor]:
        return {b.key: (stored_chunk(b, leaves) if b.key in stored_keys
                        else chunk_of(b, pack_params(leaves, b))).clone()
                for b in rs_buckets}

    def init_sync_state(params=None):
        """The numerics state, each stateful bucket's (``padded_total``
        long) and variable's compressor state, and the stale state (from
        ``params``, the true values)."""
        state = init_numerics()
        for b in buckets:
            comp = quant.get(b.key) or cast.get(b.key)
            if comp is not None:
                st = comp.init_state(torch.zeros(
                    b.padded_total, dtype=getattr(torch, b.dtype),
                    device=mesh.device))
                if st is not None:
                    state[b.key] = st
        for v in gi.info.variables:
            if v.name in pervar:
                st = pervar[v.name].init_state(torch.zeros(
                    v.shape, dtype=getattr(torch, v.dtype),
                    device=mesh.device))
                if st is not None:
                    state[v.name] = st
        if stale is not None:
            if params is None:
                raise ValueError("the stale state starts from the parameters")
            state.update(stale.init_state(param_shards(dict(flatten(params)))))
        return state

    def true_leaves(params, sync_state) -> Dict[str, torch.Tensor]:
        """The parameters' true values by name: stored members and proxied
        members come from their shards (gathered), the rest from
        ``params``."""
        leaves = dict(flatten(materialize(params, grad=False)))
        if proxied:
            masters = sync_state[stale_sync.MASTER_KEY]
            for b in rs_buckets:
                if b.key in proxied:
                    full = gather_full(b, masters[b.key])
                    for n, arr in zip(b.names, unpack_bucket(b, full)):
                        if n in proxy_names:
                            leaves[n] = arr.detach().clone()
        return leaves

    def export_params(params, sync_state):
        """The parameters' true values, logical (a gather when variables
        are stored 1/N or proxies lag)."""
        if not proxied and not stored:
            return params
        leaves = true_leaves(params, sync_state)
        return unflatten([(n, leaves[n]) for n, _ in flatten(params)])

    def export_sync_state(params, sync_state):
        """The LOGICAL sync state: the numerics state as it is, every
        compressor state stacked ``[data, ...]`` over the ranks, the stale
        state per variable (``stale_sync.StaleSync.export_state``)."""
        out: Dict[str, Any] = {}
        for key, value in sync_state.items():
            if key == NUMERICS_KEY:
                out[key] = value
            elif key not in stale_sync.STALE_KEYS + (stale_sync.MASTER_KEY,):
                out[key] = tree_map(lambda x: (coll.all_gather(x, group)
                                               if d > 1 else x)
                                    .reshape((d,) + tuple(x.shape)), value)
        if stale is not None:
            out.update(stale.export_state(sync_state, dict(flatten(params))))
        return out

    def import_sync_state(sync_state, params):
        """This rank's sync state from ``sync_state`` (the step's own
        entries as they are, the stale state logical or the step's own)
        and ``params`` (the true values); proxied variables' compute copy
        takes the mirror (``cache``) in place."""
        out = {k: v for k, v in sync_state.items()
               if k not in stale_sync.STALE_KEYS + (stale_sync.MASTER_KEY,)}
        if stale is None:
            return out
        leaves = dict(flatten(params))
        out.update(stale.import_state(sync_state, param_shards(leaves)))
        with torch.no_grad():
            for n, mirror in sync_state.get("cache", {}).items():
                if n in leaves:
                    leaves[n].copy_(mirror)
        return out

    def init_fn(params):
        leaves = dict(flatten(params))
        tree = optimizer.init(unflatten([(n, leaves[n].detach())
                                         for n in tree_names]))
        if "count" in tree:               # on the step's device, even empty
            tree["count"] = tree["count"].to(mesh.device)
        if not rs_buckets:
            return tree
        return {"vars": tree, "zero1": optimizer.init(param_shards(leaves))}

    def export_opt_state(opt_state):
        """The LOGICAL state: ZeRO-1 shards gathered to full bucket vectors
        (``padded_total`` long, in chunk order), copies on the device."""
        if not rs_buckets:
            return gt.copy_tree(opt_state)
        zero1 = {k: v.detach().clone() if isinstance(v, torch.Tensor)
                 else {key: gather_full(by_key[key], s).detach().clone()
                       for key, s in v.items()}
                 for k, v in opt_state["zero1"].items()}
        return {"vars": gt.copy_tree(opt_state["vars"]), "zero1": zero1}

    # -- the step ---------------------------------------------------------------
    warned: List[int] = []

    def gradients(params, sync_state, batch):
        """``(loss, aux, local grads, pipelined buckets' reduced values,
        their new residuals, their saturation counts)``."""
        scale = sync_state[NUMERICS_KEY]["scale"] if num_ls is not None \
            else None
        if not pipe:
            vg = vg_unscaled if scale is None and inject is None \
                else gt.scaled_value_and_grad(
                    gi, names, scale,
                    inject=inject(sync_state) if inject else None)
            loss, aux, grads = gt.local_value_and_grad(
                vg, params, batch, d, group, rank, warned)
            return loss, aux, grads, {}, {}, {}
        loss_fn = gt.scaled_loss(gi, scale)
        single = gt.value_and_grad(loss_fn, has_aux, names)
        if inject is not None:
            single = inject(sync_state)(single)
        local = gt.local_rows(batch, d, rank, warned)
        slices = gt.microbatch_slices(gt._leading_dim(local),
                                      gi.accum_steps)
        qfns = {k: (lambda v, s, b=b: quant_reduce(b, v, s))
                for b in pipe for k in [b.key] if k in quant}

        def run():
            return ov_mod.pipelined_accumulate(
                lambda mb: single(params, mb), slices,
                lambda off, rows: gt._rows(local, off, rows), has_aux, pipe,
                issue_fns, quant_fns=qfns,
                quant_states={k: sync_state[k] for k in qfns},
                stamp=lambda key, slot: stamp("reduce", key, slot))
        if local is batch:
            return run()
        with data_rows(group, d):
            return run()

    def step(params, opt_state, sync_state, batch):
        scale = sync_state[NUMERICS_KEY]["scale"] if num_ls is not None \
            else None
        # the stored buckets' compute copy lives until the gradients exist
        loss, aux, grads, pipe_red, pipe_state, pipe_sat = gradients(
            materialize(params, lend=True), sync_state, batch)
        reclaim(params)

        health = guard_mod.HealthAccumulator(d, fused=True) \
            if num_active else None
        reduced: Dict[str, torch.Tensor] = {}
        new_state: Dict[str, Any] = dict(pipe_state)
        for n, comp in pervar.items():
            g = grads[n]
            with sync_span(f"per_var_reduce/{n}"):
                grads[n], st = comp.reduce(g, sync_state.get(n), group, d)
            if n in sync_state:
                new_state[n] = st
            if health is not None:
                health.add(n, grads[n], finite_src=g,
                           saturation=guard_mod.wire_saturation(
                               g, ls_mod.wire_dtype_of(comp.name)))
        for b in buckets:
            rs = b.mode == MODE_REDUCE_SCATTER
            if b.key in pipe_red:
                red = pipe_red[b.key]
                if health is not None:
                    # a NaN survives the per-microbatch reduction: the
                    # accumulated reduced value is the finiteness source
                    health.add(b.key, red, shard_axes_size=d if rs else 1,
                               sat_count=pipe_sat.get(b.key))
                reduced[b.key] = red
                continue
            stamp("reduce", b.key)
            vec = pack_bucket(b, [grads.pop(n) for n in b.names])
            qsat = sat = None
            if b.key in quant:
                with sync_span(f"bucket_quant_reduce/{b.key}"):
                    red, new_state[b.key], qsat = quant_reduce(
                        b, vec, sync_state[b.key])
            elif b.key in cast:
                comp = cast[b.key]
                fn = comp.reduce_scatter if rs else comp.reduce
                with sync_span(f"bucket_compressed_reduce/{b.key}"):
                    red, st = fn(vec, sync_state.get(b.key), group, d)
                if b.key in sync_state:
                    new_state[b.key] = st
                if health is not None:
                    sat = guard_mod.wire_saturation(
                        vec, ls_mod.wire_dtype_of(b.compressor))
            else:
                with sync_span(f"bucket_reduce/{b.key}"):
                    red = reduce_fns[b.key](vec)
            if health is not None:
                # finiteness from the packed local vector, the norm
                # partial from the reduced value (a ZeRO-1 shard's squared
                # norm sums over the ranks to the bucket's), a cast wire's
                # saturation flag and the quantize events' count
                health.add(b.key, red, shard_axes_size=d if rs else 1,
                           finite_src=vec, saturation=sat, sat_count=qsat)
            reduced[b.key] = red
        mean_loss = _mean_over(loss, d, group)

        metrics: Dict[str, Any] = {}
        ok, mult, fused_mult = True, None, None
        if num_active:
            # ONE all_reduce of every bucket's and variable's partials
            if legs_on:
                flightrec.traced_stamp("guard/rollup",
                                       leg_kind=sir.LEG_PSUM_GUARD,
                                       device=mesh.device)
            with sync_span("guard_rollup"):
                all_finite, gnorm, per_bucket, inv_scale, mult = \
                    guard_mod.rollup(health, group if d > 1 else None, loss,
                                     scale, num_cfg.clip_norm)
            ok = bool(all_finite)       # the skip gate's one host sync
        if ok:
            if mult is not None:
                for b in buckets:
                    if b.mode == MODE_ALL_REDUCE or not update_fused:
                        reduced[b.key].mul_(mult)
                for n in pervar:
                    grads[n].mul_(mult)
                fused_mult = mult if update_fused else None
            if stale is not None:
                for b in rs_buckets:
                    reduced[b.key] = stale.exchange(b.key, reduced[b.key],
                                                    sync_state)
            for b in ar_buckets:
                grads.update(zip(b.names, unpack_bucket(b, reduced[b.key])))
            _update(params, opt_state, sync_state, grads, reduced,
                    fused_mult)
            sync_state.update(new_state)   # a skipped step keeps the old

        if num_active:
            metrics["grad_health"] = guard_mod.close_step(
                sync_state, all_finite, gnorm, per_bucket, num_ls)
            if scale is not None:
                mean_loss = mean_loss * inv_scale
        metrics["loss"] = mean_loss
        if aux is not None:
            metrics["aux"] = tree_map(lambda x: _mean_over(x, d, group), aux)
        if extra_metrics_fn is not None:
            with torch.no_grad():
                metrics = gt.merge_metrics(metrics, extra_metrics_fn(
                    materialize(params, grad=False), batch))
        return metrics

    @torch.no_grad()
    def _update(params, opt_state, sync_state, grads, reduced, fused_mult):
        """The ZeRO-1 shard update, the tree update, then the gather."""
        if not rs_buckets:
            stamp("update", "~tree")
            with sync_span("tree_update"):
                optimizer.step_(params, grads, opt_state)
            return
        leaves = dict(flatten(params))
        masters = sync_state.get(stale_sync.MASTER_KEY, {})
        p_shards = {b.key: masters[b.key] if b.key in proxied
                    else stored_chunk(b, leaves) if b.key in stored_keys
                    else chunk_of(b, pack_params(leaves, b))
                    for b in rs_buckets}
        z = opt_state["zero1"]
        stamp("update", rs_buckets[0].key)
        if update_fused:
            # K5, one launch per bucket shard
            with sync_span("fused_shard_update"):
                scalars = fk.adam_scalars(z["count"], spec, fused_mult)
                for b in rs_buckets:
                    k = b.key
                    p_shards[k], z["mu"][k], z["nu"][k] = \
                        fk.fused_adam_update(p_shards[k], reduced[k],
                                             z["mu"][k], z["nu"][k], scalars,
                                             spec)
                z["count"] = z["count"] + 1
        else:
            with sync_span("zero1_shard_update"):
                optimizer.step_(p_shards, {b.key: reduced[b.key]
                                           for b in rs_buckets}, z)
        with sync_span("tree_update"):
            optimizer.step_(params, grads, opt_state["vars"])
        refresh = stale is not None and stale.refresh_due(sync_state)
        for k in proxied:
            masters[k] = p_shards[k]
        for b in stored:            # kept as they are: gathered next step
            write_parts(b, leaves, p_shards[b.key])
        if stale is not None:
            stale.advance(sync_state)
        for b in gathers:
            if b.key in stored_keys:
                continue
            # a proxied bucket gathers on refresh steps, or for its
            # members that are not proxied
            keep = proxy_names if b.key in proxied and not refresh else ()
            if keep and set(b.names) <= keep:
                continue
            stamp("gather", b.key)
            with sync_span(f"param_gather/{b.key}"):
                full = gather_full(b, p_shards[b.key])
            for n, arr in zip(b.names, unpack_bucket(b, full)):
                if n not in keep:
                    leaves[n].copy_(arr)

    shapes = {v.name: (tuple(v.shape), v.dtype) for v in gi.info.variables}
    return gt.DistributedStep(
        step_fn=step, init_fn=init_fn,
        eval_fn=gt.make_eval_step(gi.loss_fn, has_aux, extra_metrics_fn),
        mesh=mesh, trainable=names, buckets=tuple(buckets),
        zero1_buckets=tuple(rs_buckets), fused_kernels=active,
        bucket_algs=algs, hier_keys=hier_keys,
        pipelined_keys=tuple(b.key for b in pipe),
        shard_owner={b.key: owner(b) for b in rs_buckets},
        init_sync_state=init_sync_state,
        export_opt_state=export_opt_state, export_params=export_params,
        export_sync_state=export_sync_state,
        import_sync_state=import_sync_state,
        stored_shapes={n: shapes[n] for b in stored for n in b.names},
        shard_params=shard_params, schedule_ir=ir)
