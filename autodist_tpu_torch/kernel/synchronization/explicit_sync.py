"""The explicit bucketed training step, for all-reduce and ZeRO-1 buckets.

Port of the JAX package's ``kernel/synchronization/explicit_sync.py``
(``:96-119, 223-246, 249-1180``).  Reduce-scatter (ZeRO-1) buckets hold
the variables of ``Zero1`` plans and of every PS plan: the PS family's
weight-update sharding, which the JAX package lowers through GSPMD
(``graph_transformer.py:428-470``), runs here as the same
reduce-scatter → 1/N shard update → all-gather.  One step may mix both
kinds (``Parallax``: the embedding's PS plan in a reduce-scatter bucket,
the dense variables' AllReduce plans in all-reduce buckets).  The step
runs, on each rank, in order:

1. loss and gradients on this rank's rows of the global batch (inside
   :func:`~autodist_tpu_torch.mesh.data_rows`), the loss
   multiplied by the loss scale first when one is on; with
   ``accum_steps > 1`` the microbatches accumulate inside the step;
2. per bucket of :func:`plan_step_buckets`' plan: pack, then the
   reduction over the data group under the bucket's lowering
   (``overlap.reduce_alg`` of the resolved :class:`~.overlap.
   OverlapPlan`; no collective at data size 1):

   * an uncompressed bucket through ``overlap.bucket_reduce_fn``: the
     backend's ``all_reduce`` / ``reduce_scatter``, whatever its label;
   * a quantized bucket (``Int8Compressor``, ``Fp8Compressor``) through
     its compressor's ``bucket_reduce`` / ``bucket_reduce_scatter``: the
     quantized ring under explicit ``"ring"`` / ``"full"`` at 256 KiB and
     above, its hop boundaries through K6–K8 (``quant_ring``), else the
     one-shot ``all_to_all``; the error-feedback residual (this rank's
     ``padded_total`` vector in the sync state, under the bucket key) is
     added before quantization and replaced by the new one;
3. with ``capture(numerics=...)``, the guard: each bucket's finiteness
   from its packed local vector and its squared-norm partial from the
   reduced value, both by K4
   (:func:`~autodist_tpu_torch.ops.fused_kernels.fused_detect_stats`),
   and a quantized bucket's saturation count, rolled into one
   :class:`~autodist_tpu_torch.numerics.GradHealth` by ONE all_reduce;
   the clip multiplier is ``inv_scale x clip``;
4. the skip gate: ``all_finite`` is read on the host once, before any
   update (the step updates in place, so the JAX package's select between
   the updated and the old state would cost a full copy of both).  A
   non-finite step updates nothing: params, optimizer state, ZeRO-1
   shards and error-feedback residuals stay bit-identical; the loss-scale
   state still moves and ``skipped_steps`` counts the skip;
5. the ZeRO-1 update of this rank's 1/N shard of each bucket: K5
   (:func:`~autodist_tpu_torch.ops.fused_kernels.fused_adam_update`) when
   the optimizer is ``fusable_adam``, its state Adam-shaped and the
   buckets f32; otherwise the optimizer's own update on the shards, with
   the drop reason in a warning.  This is decided from the configuration
   when the step is built;
6. the tree update of every other variable (the all-reduce buckets'
   members and anything unbucketed), then the ``all_gather`` of
   each updated shard in ``overlap.gather_schedule`` order and the unpack
   into the parameters;
7. metrics: ``loss`` averaged over the data group and unscaled,
   ``grad_health``, ``aux`` averaged, the ``metrics_fn`` extras.

Optimizer state: without ZeRO-1 buckets, the tree state of the plain step;
with them, ``{"vars": tree state of the other variables, "zero1": the
optimizer's state over {bucket key: this rank's shard}}``, so each rank
holds 1/N of every bucket's moments.

Differences from the JAX package, none of which changes a result: the
schedule IR (P8) is not built (each bucket's lowering label comes from
the same rule, ``overlap.reduce_alg``); an uncompressed bucket labelled
``"ring"`` or ``"one_shot"`` reduces, and a ZeRO-1 shard gathers, through
the backend's collective, not as ring hops (the same sum up to its last
bits); buckets reduce in ``assign_buckets``' order; the step runs at every data size, where the
JAX package takes its GSPMD step at size 1; the quantized ring's hop
kernels run whenever a bucket is quantized (the JAX package's are an
opt-in; both put the same bits on the wire).  The accumulation pipeline,
the hierarchical and per-variable tiers and the flight-recorder stamps
are refused or absent until their ROADMAP items.  Under a PS plan the
parameters stay replicated between steps; the JAX package holds
PS-partitioned variables and a sparse embedding 1/N per rank
(``param_spec = P("data")``), the same losses and parameters for more
memory here.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List

import torch

from autodist_tpu_torch.graph_item import flatten, tree_map, unflatten
from autodist_tpu_torch.kernel import graph_transformer as gt
from autodist_tpu_torch.kernel.synchronization import collectives as coll
from autodist_tpu_torch.kernel.synchronization import overlap as ov_mod
from autodist_tpu_torch.kernel.synchronization import quant_ring
from autodist_tpu_torch.kernel.synchronization.bucketing import (
    DEFAULT_BUCKET_BYTES, MODE_ALL_REDUCE, MODE_REDUCE_SCATTER, Bucket,
    assign_buckets, bucket_drop_reason, pack_bucket, unpack_bucket)
from autodist_tpu_torch.kernel.synchronization.compressor import \
    get_compressor
from autodist_tpu_torch.numerics import guard as guard_mod
from autodist_tpu_torch.numerics import loss_scale as ls_mod
from autodist_tpu_torch.numerics.guard import NUMERICS_KEY
from autodist_tpu_torch.ops import fused_kernels as fk


def uses_explicit_path(compiled) -> bool:
    """Does the plan need the explicit bucketed step?  A compressor,
    ZeRO-1 (``reduce_scatter``), a non-zero ``bucket_bytes`` and an
    explicit ``pipeline``/``ring``/``full`` schedule do.  (The JAX
    package's other reasons, fused groups and ``hier``, are refused before
    this is asked.)"""
    return any(plan.compressor not in ("", "NoneCompressor")
               or plan.sync_mode == MODE_REDUCE_SCATTER or plan.bucket_bytes
               or plan.overlap in (ov_mod.OVERLAP_PIPELINE,
                                   ov_mod.OVERLAP_RING, ov_mod.OVERLAP_FULL)
               for plan in compiled.var_plans.values())


def plan_step_buckets(gi, compiled, d: int) -> List[Bucket]:
    """The step's buckets: every synced variable whose compressor composes
    with flat buckets, in catalog order, keyed by (mode, dtype,
    compressor, group), capped by the largest ``bucket_bytes`` of the
    plans and padded to a multiple of the data size ``d``."""
    entries = []
    cap = 0
    for v in gi.info.variables:
        plan = compiled.var_plans.get(v.name)
        if plan is None:
            continue
        comp = plan.compressor or "NoneCompressor"
        if bucket_drop_reason((), False, comp) is not None:
            continue
        entries.append((v.name, v.shape, v.dtype, comp, plan.group,
                        plan.sync_mode or MODE_ALL_REDUCE))
        cap = max(cap, plan.bucket_bytes)
    return assign_buckets(entries, bucket_bytes=cap or DEFAULT_BUCKET_BYTES,
                          shard_divisor=max(d, 1))


def _mean_over(x: torch.Tensor, d: int, group) -> torch.Tensor:
    if d == 1:
        return x
    return coll.all_reduce(x, group) / d


def make_explicit_step(gi, compiled, extra_metrics_fn=None
                       ) -> "gt.DistributedStep":
    """The explicit bucketed step of ``gi`` under ``compiled`` (see the
    module docstring), as a :class:`~autodist_tpu_torch.kernel.
    graph_transformer.DistributedStep`."""
    mesh = compiled.mesh
    d, group, rank = mesh.data_size, mesh.data_group, mesh.data_rank
    names = tuple(v.name for v in gi.info.trainable_variables)
    buckets = plan_step_buckets(gi, compiled, d)
    rs_buckets = [b for b in buckets if b.mode == MODE_REDUCE_SCATTER]
    ar_buckets = [b for b in buckets if b.mode == MODE_ALL_REDUCE]
    rs_names = {n for b in rs_buckets for n in b.names}
    tree_names = tuple(n for n in names if n not in rs_names)
    optimizer, has_aux = gi.optimizer, gi.has_aux

    # -- the schedule: each bucket's lowering, resolved when it is built ------
    ov = ov_mod.resolve_overlap(
        [plan.overlap for plan in compiled.var_plans.values()],
        accum_steps=gi.accum_steps, buckets=buckets, d=d,
        has_rs=bool(rs_buckets))
    for key, why in ov.drops:
        warnings.warn(f"explicit sync path: overlap scheduling skipped for "
                      f"bucket {key} ({why})")
    algs = {b.key: ov_mod.reduce_alg(b, ov, d) for b in buckets}
    quant = {b.key: get_compressor(b.compressor) for b in buckets
             if quant_ring.is_quant_ring_compressor(b.compressor)}
    reduce_fns = {b.key: ov_mod.bucket_reduce_fn(b, group, d)
                  for b in buckets if b.key not in quant}
    gathers = ov_mod.gather_schedule(rs_buckets, ov.prefetch)

    # -- numerics guard: resolved when the step is built --------------------
    num_cfg = gi.numerics
    num_active = num_cfg is not None and num_cfg.guard
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
    adam_shaped = True
    if spec is not None and rs_buckets:
        adam_shaped = fk.find_adam_state(
            optimizer.init({"x": torch.zeros(8)})) is not None
    active, drops = fk.resolve_fused(
        guard=num_active, has_rs=bool(rs_buckets), has_quant_ring=bool(quant),
        optimizer_fusable=spec is not None, adam_state_shaped=adam_shaped,
        f32_buckets=all(b.dtype == "float32" for b in rs_buckets))
    for kernel, why in drops:
        warnings.warn(f"explicit sync path: fused kernel {kernel} is not "
                      f"used, the ZeRO-1 shards take the unfused update "
                      f"({why})")
    update_fused = fk.KERNEL_UPDATE in active

    vg_unscaled = gt.scaled_value_and_grad(gi, names, None)

    def quant_reduce(b: Bucket, vec: torch.Tensor, state):
        """``(reduced, new residual, saturation count)`` of a quantized
        bucket under its lowering; a ring's hop boundaries run K6–K8."""
        comp = quant[b.key]
        fn = comp.bucket_reduce_scatter if b.mode == MODE_REDUCE_SCATTER \
            else comp.bucket_reduce
        return fn(vec, state, group, d, alg=algs[b.key])

    init_numerics = gt.sync_state_init(num_active, num_ls, mesh.device)

    def init_sync_state():
        """The numerics state and each quantized bucket's zero residual
        (this rank's, ``padded_total`` long)."""
        state = init_numerics()
        for b in buckets:
            if b.key in quant:
                state[b.key] = quant[b.key].init_state(torch.zeros(
                    b.padded_total, dtype=getattr(torch, b.dtype),
                    device=mesh.device))
        return state

    # -- state ------------------------------------------------------------------
    def shard_of(vec: torch.Tensor, b: Bucket) -> torch.Tensor:
        if d == 1:
            return vec
        sz = b.padded_total // d
        return vec[rank * sz:(rank + 1) * sz]

    def pack_params(leaves, b: Bucket) -> torch.Tensor:
        return pack_bucket(b, [leaves[n].detach() for n in b.names])

    def init_fn(params):
        leaves = dict(flatten(params))
        tree = optimizer.init(unflatten([(n, leaves[n].detach())
                                         for n in tree_names]))
        if "count" in tree:               # on the step's device, even empty
            tree["count"] = tree["count"].to(mesh.device)
        if not rs_buckets:
            return tree
        shards = {b.key: shard_of(pack_params(leaves, b), b).clone()
                  for b in rs_buckets}
        return {"vars": tree, "zero1": optimizer.init(shards)}

    by_key = {b.key: b for b in rs_buckets}

    def export_opt_state(opt_state):
        """The LOGICAL state: ZeRO-1 shards all-gathered to full bucket
        vectors (``padded_total`` long), copies on the device."""
        if not rs_buckets:
            return gt.copy_tree(opt_state)

        def full(shard):
            if d == 1:
                return shard.detach().clone()
            return coll.all_gather(shard, group)
        zero1 = {k: v.detach().clone() if isinstance(v, torch.Tensor)
                 else {key: full(s) for key, s in v.items()}
                 for k, v in opt_state["zero1"].items()}
        return {"vars": gt.copy_tree(opt_state["vars"]), "zero1": zero1}

    # -- the step ---------------------------------------------------------------
    warned: List[int] = []

    def step(params, opt_state, sync_state, batch):
        scale = sync_state[NUMERICS_KEY]["scale"] if num_ls is not None \
            else None
        vg = vg_unscaled if scale is None \
            else gt.scaled_value_and_grad(gi, names, scale)
        loss, aux, grads = gt.local_value_and_grad(vg, params, batch, d,
                                                   group, rank, warned)

        health = guard_mod.HealthAccumulator(d, fused=True) \
            if num_active else None
        reduced: Dict[str, torch.Tensor] = {}
        residuals: Dict[str, torch.Tensor] = {}
        for b in buckets:
            vec = pack_bucket(b, [grads.pop(n) for n in b.names])
            rs = b.mode == MODE_REDUCE_SCATTER
            qsat = None
            if b.key in quant:
                red, residuals[b.key], qsat = quant_reduce(
                    b, vec, sync_state[b.key])
            else:
                red = reduce_fns[b.key](vec)
            if health is not None:
                # finiteness from the packed local vector, the norm
                # partial from the reduced value (a ZeRO-1 shard's squared
                # norm sums over the ranks to the bucket's), and the
                # saturation this rank's quantize events counted
                health.add(b.key, red, shard_axes_size=d if rs else 1,
                           finite_src=vec, sat_count=qsat)
            reduced[b.key] = red
        mean_loss = _mean_over(loss, d, group)

        metrics: Dict[str, Any] = {}
        ok, mult, fused_mult = True, None, None
        if num_active:
            all_finite, gnorm, per_bucket, inv_scale, mult = guard_mod.rollup(
                health, group if d > 1 else None, loss, scale,
                num_cfg.clip_norm)
            ok = bool(all_finite)       # the skip gate's one host sync
        if ok:
            if mult is not None:
                for b in buckets:
                    if b.mode == MODE_ALL_REDUCE or not update_fused:
                        reduced[b.key].mul_(mult)
                fused_mult = mult if update_fused else None
            for b in ar_buckets:
                grads.update(zip(b.names, unpack_bucket(b, reduced[b.key])))
            _update(params, opt_state, grads, reduced, fused_mult)
            sync_state.update(residuals)   # a skipped step keeps the old

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
                metrics = gt.merge_metrics(metrics,
                                           extra_metrics_fn(params, batch))
        return metrics

    @torch.no_grad()
    def _update(params, opt_state, grads, reduced, fused_mult):
        """The ZeRO-1 shard update, the tree update, then the gather."""
        if not rs_buckets:
            optimizer.step_(params, grads, opt_state)
            return
        leaves = dict(flatten(params))
        p_shards = {b.key: shard_of(pack_params(leaves, b), b)
                    for b in rs_buckets}
        z = opt_state["zero1"]
        if update_fused:
            scalars = fk.adam_scalars(z["count"], spec, fused_mult)
            for b in rs_buckets:
                k = b.key
                p_shards[k], z["mu"][k], z["nu"][k] = fk.fused_adam_update(
                    p_shards[k], reduced[k], z["mu"][k], z["nu"][k], scalars,
                    spec)
            z["count"] = z["count"] + 1
        else:
            optimizer.step_(p_shards, {b.key: reduced[b.key]
                                       for b in rs_buckets}, z)
        optimizer.step_(params, grads, opt_state["vars"])
        for b in gathers:
            shard = p_shards[b.key]
            full = shard if d == 1 else coll.all_gather(shard, group)
            for n, arr in zip(b.names, unpack_bucket(b, full)):
                leaves[n].copy_(arr)

    return gt.DistributedStep(
        step_fn=step, init_fn=init_fn,
        eval_fn=gt.make_eval_step(gi.loss_fn, has_aux, extra_metrics_fn),
        mesh=mesh, trainable=names, buckets=tuple(buckets),
        zero1_buckets=tuple(rs_buckets), fused_kernels=active,
        bucket_algs=algs, init_sync_state=init_sync_state,
        export_opt_state=export_opt_state)
