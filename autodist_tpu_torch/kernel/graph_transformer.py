"""GraphTransformer: lower the captured program into a distributed step.

Port of the JAX package's ``kernel/graph_transformer.py``.  Plans that
need the explicit bucketed step (a compressor, the ``reduce_scatter`` of
``Zero1`` and of every PS plan, a non-zero ``bucket_bytes``, an explicit
``ring`` or ``full`` schedule) go to :func:`~autodist_tpu_torch.kernel.
synchronization.explicit_sync.make_explicit_step` (``:228``); the PS
family's weight-update sharding, which the JAX package runs on its GSPMD
step (``:428-470``), runs there, and so does any plan whose variable
keeps a ``model``, ``expert`` or ``pipe`` sharding (the explicit path's
per-shard tier, where the JAX package shards through GSPMD).  A captured
``grad_fn`` (``capture(grad_fn=)``: the 1F1B pipeline backward) replaces
autograd on either step, with the JAX package's contract and refusals
(:func:`manual_value_and_grad`, :func:`check_grad_fn_program`; loss
scaling off, :func:`resolve_grad_fn_loss_scale`).  The batch is cut
over ``data`` only: the ranks of a pipe group see the same rows.  Every
other plan (``AllReduce``,
and ``PartitionedAR``, ``RandomAxisPartitionAR`` on a mesh without
``model``: replicated AllReduce plans) runs the twin of the JAX GSPMD
step (``:325-493``).
One such step runs, in order:

1. loss and gradients: ``loss_fn`` under autograd on this rank's rows of
   the global batch (its slice of the ``data`` axis), inside
   :func:`~autodist_tpu_torch.mesh.data_rows` so that a loss that is not
   a mean over rows (BERT's masked mean) keeps the global batch's value;
   on a ``seq`` axis, on this rank's chunk of the batch's sequences
   (:func:`seq_rows`, inside :func:`~autodist_tpu_torch.mesh.seq_chunk`),
   the loss and the gradients then summed over the seq group (every
   parameter is replicated over ``seq``);
2. accumulation: with ``accum_steps > 1`` the gradients are averaged over
   microbatches in f32 — the even split of ``_accumulate_grads`` or the
   row-weighted uneven tail of ``_uneven_accumulate``;
3. data-parallel sync: when ``data`` is wider than 1, one ``all_reduce``
   per bucket of :func:`~autodist_tpu_torch.kernel.synchronization.
   bucketing.assign_buckets`' plan, then the mean over the data group
   (NCCL on the card, gloo on CPU ranks); at width 1 there is no
   collective;
4. with ``capture(numerics=...)``, the guard over the averaged gradients,
   per variable and unfused (``HealthAccumulator(1)``, as the JAX GSPMD
   step does, ``:440-460``): unscale and clip multiply the gradients, and
   a non-finite step (``all_finite`` read on the host once) updates
   nothing;
5. the optimizer update, in place under ``torch.no_grad()``; frozen
   variables get no gradient, no update and no state;
6. metrics: ``{"loss"}``, plus ``grad_health``, ``aux`` and the
   ``metrics_fn`` extras (computed on the updated parameters and the
   global batch).

The cast and low-rank compressors, fused groups, the accumulation
pipeline, ``hier`` and PS staleness and proxy variables all run on the
explicit step.
"""
from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autodist_tpu_torch.graph_item import flatten, tree_map, unflatten
from autodist_tpu_torch.kernel.synchronization import collectives as coll
from autodist_tpu_torch.kernel.synchronization.bucketing import (
    MODE_ALL_REDUCE, Bucket, assign_buckets, pack_bucket, unpack_bucket)
from autodist_tpu_torch.const import P10, not_ported
from autodist_tpu_torch.mesh import (SeqChunk, data_rows, manual_axes,
                                     seq_chunk)
from autodist_tpu_torch.numerics import guard as guard_mod
from autodist_tpu_torch.numerics import loss_scale as ls_mod
from autodist_tpu_torch.numerics.guard import NUMERICS_KEY


def copy_tree(tree):
    """Detached copies of a tree's tensors."""
    return tree_map(lambda x: x.detach().clone(), tree)


def sync_state_init(guard: bool, loss_scale, device) -> Callable:
    """``(params=None) -> sync state``: the numerics state under
    :data:`~autodist_tpu_torch.numerics.NUMERICS_KEY` with the guard on,
    ``{}`` without it."""
    if not guard:
        return lambda params=None: {}
    return lambda params=None: {
        NUMERICS_KEY: ls_mod.init_state(loss_scale, device)}


@dataclass
class DistributedStep:
    """The lowered step and what running it needs.

    ``step_fn(params, opt_state, sync_state, batch) -> metrics`` updates
    ``params``, ``opt_state`` and ``sync_state`` (the numerics state under
    :data:`~autodist_tpu_torch.numerics.NUMERICS_KEY` with the guard on,
    each stateful bucket's and variable's compressor state under its key,
    the stale state under ``queue``/``step``/``master``; ``{}`` without
    any) in place; ``batch`` is the placed GLOBAL batch.
    ``eval_fn(params, batch) -> metrics`` changes nothing.
    ``zero1_buckets`` are the
    buckets whose optimizer state is sharded over the data axis,
    ``shard_owner`` the chunk of each this rank holds (its rank, or the
    two-tier permutation's chunk), ``fused_kernels`` names the fused
    kernels the step runs (``"guard"``: K4, ``"update"``: K5,
    ``"quant_hop"``: K6–K8), ``bucket_algs`` each bucket's reduction
    (``"ring"``, ``"one_shot"`` or ``"fused"``), ``hier_keys`` the
    buckets that reduce in two tiers and ``pipelined_keys`` those that
    reduce once per microbatch (the accumulation pipeline).  ``init_sync_state(params)`` makes a
    fresh sync state; ``export_params`` / ``export_sync_state`` give the
    true parameters and the logical sync state (collectives: every rank
    calls them), ``import_sync_state(sync_state, params)`` this rank's
    sync state back from it.  ``stored_shapes`` gives the logical
    ``(shape, dtype)`` of each variable stored 1/N between steps (data
    size > 1) or sharded over ``model``, by name, and
    ``shard_params(params)`` cuts a placed tree to this rank's parts of
    them (the step's own layout; the identity without them).
    ``model_shards`` maps each variable sharded over ``model`` or
    ``expert`` to ``(tensor dim, shard count, this rank's shard)``;
    ``shard_cuts`` maps every sharded variable, the stage stacks cut over
    ``pipe`` too, to its cuts in order (the stage dim first); its
    optimizer slots and compressor state are shards too, and
    ``shard_opt_state(opt_state)`` cuts a logical optimizer state to them
    (the identity without any)."""

    step_fn: Callable
    init_fn: Callable            # params -> optimizer state
    eval_fn: Callable
    mesh: Any
    trainable: Tuple[str, ...]
    buckets: Tuple[Bucket, ...] = ()
    zero1_buckets: Tuple[Bucket, ...] = ()
    fused_kernels: Tuple[str, ...] = ()
    bucket_algs: Dict[str, str] = field(default_factory=dict)
    hier_keys: Tuple[str, ...] = ()
    pipelined_keys: Tuple[str, ...] = ()
    shard_owner: Dict[str, int] = field(default_factory=dict)
    init_sync_state: Callable = lambda params=None: {}
    export_opt_state: Callable = copy_tree  # state -> logical copy
    export_params: Callable = lambda params, sync_state: params
    export_sync_state: Callable = lambda params, sync_state: dict(sync_state)
    import_sync_state: Callable = lambda sync_state, params: sync_state
    stored_shapes: Dict[str, Tuple[Tuple[int, ...], str]] = field(
        default_factory=dict)
    shard_params: Callable = lambda params: params
    model_shards: Dict[str, Tuple[int, int, int]] = field(
        default_factory=dict)
    shard_cuts: Dict[str, Tuple[Tuple[int, int, int], ...]] = field(
        default_factory=dict)
    shard_opt_state: Callable = lambda opt_state: opt_state
    #: the :class:`~autodist_tpu_torch.strategy.compiler.CompiledStrategy`
    #: this step lowers (set by :meth:`GraphTransformer.transform`)
    compiled_strategy: Any = None
    #: the verified schedule IR of the step's sync
    #: (:mod:`~autodist_tpu_torch.kernel.synchronization.schedule_ir`)
    schedule_ir: Any = None

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def place_params(self, params):
        """A copy of ``params`` (tensors or numpy arrays, logical) on the
        mesh's device in the step's layout (:attr:`shard_params`);
        trainable leaves that are not stored 1/N require grad.  The
        caller's tensors are never updated in place."""
        named = []
        for name, leaf in flatten(params):
            t = torch.as_tensor(leaf).detach().to(self.device).clone()
            named.append((name, t.requires_grad_(
                name in self.trainable and name not in self.stored_shapes)))
        return self.shard_params(unflatten(named))

    def place_batch(self, batch):
        """Every array leaf as a tensor on the mesh's device."""
        def put(x):
            if isinstance(x, torch.Tensor):
                return x.to(self.device)
            if isinstance(x, np.ndarray):
                return torch.from_numpy(np.ascontiguousarray(x)) \
                    .to(self.device)
            return x
        return tree_map(put, batch)


def map_var_leaves(tree, names, fn: Callable,
                   prefix: Tuple[str, ...] = ()):
    """``tree`` (an optimizer state, a nested dict) with ``fn(leaf,
    name)`` applied to each tensor whose path ends in one of ``names``
    (a variable's slot in a per-variable state: ``mu/<name>``); every
    other leaf, and the structure, as it is."""
    if isinstance(tree, dict):
        return {k: map_var_leaves(v, names, fn, prefix + (k,))
                for k, v in tree.items()}
    if names and isinstance(tree, torch.Tensor):
        for i in range(len(prefix)):
            name = "/".join(prefix[i:])
            if name in names:
                return fn(tree, name)
    return tree



def microbatch_slices(length: int, accum: int) -> List[Tuple[int, int]]:
    """``(offset, rows)`` per microbatch: an even split when ``accum``
    divides ``length``, else the first ``length % accum`` microbatches
    carry one extra row."""
    if accum > length:
        raise ValueError(
            f"accum_steps={accum} exceeds the local batch rows ({length})")
    base, rem = divmod(length, accum)
    out, off = [], 0
    for s in [base + 1] * rem + [base] * (accum - rem):
        out.append((off, s))
        off += s
    return out


def _rows(batch, off: int, rows: int):
    return tree_map(lambda x: x[off:off + rows]
                    if isinstance(x, torch.Tensor) and x.dim() else x, batch)


def _leading_dim(batch) -> int:
    dims = {x.shape[0] for _, x in flatten(batch)
            if isinstance(x, torch.Tensor) and x.dim()}
    if len(dims) != 1:
        raise ValueError(
            f"batch leaves disagree on the leading dim: {sorted(dims)}")
    return dims.pop()


def _detach(tree):
    return tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor)
                    else x, tree)


def local_rows(batch, data: int, rank: int, warned: List[int]):
    """This rank's rows of the global batch (all of it at data size 1, or,
    with a warning once per size, when the rows do not divide)."""
    if data == 1:
        return batch
    n = _leading_dim(batch)
    if n % data:
        if n not in warned:
            warned.append(n)
            warnings.warn(
                f"batch with leading dim {n} is not divisible by the data "
                f"axis (size {data}); every rank runs the whole batch — pad "
                f"the global batch for data parallelism")
        return batch
    return _rows(batch, rank * (n // data), n // data)


def seq_rows(batch, size: int, rank: int):
    """Chunk ``rank`` of ``size`` of the batch's sequence leaves, by the
    JAX package's rule (``batch_sharding_for_leaf``): dim 1 of a leaf of
    rank >= 2 is cut when it equals the largest dim 1 of those leaves and
    ``size`` divides it; other leaves stay whole.  Returns ``batch``
    itself when nothing is cut."""
    dims = [x.shape[1] for _, x in flatten(batch)
            if isinstance(x, torch.Tensor) and x.dim() >= 2]
    if not dims or max(dims) % size:
        return batch
    t = max(dims)
    n = t // size
    return tree_map(lambda x: x[:, rank * n:(rank + 1) * n]
                    if isinstance(x, torch.Tensor) and x.dim() >= 2
                    and x.shape[1] == t else x, batch)


def mesh_seq_chunk(mesh) -> Optional[SeqChunk]:
    """This rank's :class:`~autodist_tpu_torch.mesh.SeqChunk` on a mesh
    with a ``seq`` axis wider than 1, else None."""
    size = getattr(mesh, "seq_size", 1)
    return SeqChunk(mesh.seq_group, size, mesh.seq_rank) if size > 1 \
        else None


def check_seq_program(gi, mesh) -> None:
    """On a ``seq`` axis wider than 1 the captured loss must compute on a
    chunk of each sequence (``loss_fn.sequence_parallel``: the flagship
    LM's), on a mesh without ``pipe``; any other program raises naming
    P10."""
    if getattr(mesh, "seq_size", 1) > 1 and getattr(mesh, "pipe_size",
                                                    1) > 1:
        raise not_ported(f"a pipe axis of size {mesh.pipe_size} with a seq "
                         f"axis of size {mesh.seq_size}", P10)
    if getattr(mesh, "seq_size", 1) > 1 and not getattr(
            gi.loss_fn, "sequence_parallel", False):
        raise not_ported(
            f"training {getattr(gi.loss_fn, '__qualname__', 'this loss')} "
            f"on a seq axis of size {mesh.seq_size} (only the "
            f"transformer_lm loss computes on sequence chunks)", P10)


def seq_sum(loss, grads: Dict[str, torch.Tensor], group):
    """The loss and each gradient summed over the seq ``group``: one
    ``all_reduce`` per gradient dtype over the gradients packed flat."""
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for n, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(n)
    out = dict(grads)
    for names in by_dtype.values():
        flat = coll.all_reduce(torch.cat([grads[n].reshape(-1)
                                          for n in names]), group)
        for n, part in zip(names, flat.split([grads[n].numel()
                                              for n in names])):
            out[n] = part.view(grads[n].shape)
    return coll.all_reduce(loss, group), out


def local_value_and_grad(vg: Callable, params, batch, data: int, group,
                         rank: int, warned: List[int],
                         seq: Optional[SeqChunk] = None):
    """``vg`` on this rank's rows of the global ``batch``, inside
    :func:`~autodist_tpu_torch.mesh.data_rows` when they are a ``1/data``
    slice of it; with ``seq``, on this rank's chunk of the sequences
    inside :func:`~autodist_tpu_torch.mesh.seq_chunk`, the loss and the
    gradients then summed over the seq group (a batch whose sequences do
    not divide over the axis runs whole on every rank of it)."""
    local = local_rows(batch, data, rank, warned)
    chunked = seq_rows(local, seq.size, seq.rank) if seq is not None \
        else local
    with contextlib.ExitStack() as stack:
        stack.enter_context(manual_axes())
        if local is not batch:
            stack.enter_context(data_rows(group, data))
        if chunked is local:
            return vg(params, local)
        stack.enter_context(seq_chunk(seq.group, seq.size, seq.rank))
        loss, aux, grads = vg(params, chunked)
    loss, grads = seq_sum(loss, grads, seq.group)
    return loss, aux, grads


def value_and_grad(loss_fn: Callable, has_aux: bool, names: Tuple[str, ...]):
    """``vg(params, batch) -> (loss, aux, {name: grad})`` by autograd."""
    def vg(params, batch):
        leaves = dict(flatten(params))
        out = loss_fn(params, batch)
        loss, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in zip(names, grads)}
        return loss.detach(), _detach(aux), grads
    return vg


def manual_value_and_grad(grad_fn: Callable, names: Tuple[str, ...]):
    """``vg(params, batch) -> (loss, None, {name: grad})`` of a captured
    ``grad_fn(params, batch) -> (loss, grads)`` (the JAX package's
    contract, ``graph_transformer.py:293-305``): the parameters it is
    given are the ones the loss would see (logical, but for a stage
    stack, which is this rank's stages inside a step), the gradients it
    returns are theirs, a variable it leaves out gets zeros.  The port
    keeps no padded shard, so nothing is padded or unpadded around it."""
    def vg(params, batch):
        leaves = dict(flatten(params))
        loss, grads = grad_fn(params, batch)
        got = dict(flatten(grads))
        out = {n: (got[n].detach() if n in got
                   else torch.zeros_like(leaves[n])) for n in names}
        return loss.detach(), None, out
    return vg


def resolve_grad_fn_loss_scale(gi, loss_scale):
    """``loss_scale``, or None with the JAX package's warning when the
    captured ``grad_fn`` owns the backward pass (``graph_transformer.py:
    349-352``): the scale cannot be threaded through it."""
    if loss_scale is not None and gi.grad_fn is not None:
        warnings.warn(
            "numerics: loss scaling disabled — capture(grad_fn=...) owns "
            "the backward pass, so the scale cannot be threaded through "
            "it (guard/clip/skip stay active)")
        return None
    return loss_scale


def check_grad_fn_program(gi, compiled) -> None:
    """A captured ``grad_fn`` does not combine with what the JAX package
    lowers on its explicit path (a compressor, fused groups, ZeRO-1, an
    explicit schedule: ``graph_transformer.py:229-234``), which raises
    its ``ValueError``."""
    from autodist_tpu_torch.kernel.synchronization import explicit_sync

    if gi.grad_fn is not None and explicit_sync.uses_explicit_path(
            compiled, skip_ps=True):
        raise ValueError(
            "capture(grad_fn=...) cannot combine with gradient "
            "compressors / fused groups (the explicit shard_map "
            "path owns the gradient computation); drop the "
            "compressor or the manual grad_fn")


def accumulate(vg: Callable, accum: int, has_aux: bool):
    """``vg`` averaged over ``accum`` microbatches, accumulated in f32 and
    cast back to the gradients' dtypes (``_accumulate_grads`` and
    ``_uneven_accumulate`` of the JAX package).  With ``has_aux`` the aux
    comes back stacked along a leading ``[accum]`` axis."""
    def vg_accum(params, batch):
        length = _leading_dim(batch)
        even = length % accum == 0
        loss_acc = g_acc = None
        dtypes: Dict[str, torch.dtype] = {}
        auxs = []
        for off, rows in microbatch_slices(length, accum):
            loss, aux, g = vg(params, _rows(batch, off, rows))
            auxs.append(aux)
            # even: plain sums, divided once at the end; uneven: each
            # microbatch weighted by its share of the rows
            w = 1.0 if even else rows / length
            if g_acc is None:
                dtypes = {n: x.dtype for n, x in g.items()}
                loss_acc = w * loss.float()
                g_acc = {n: w * x.float() for n, x in g.items()}
            else:
                loss_acc = loss_acc + w * loss.float()
                g_acc = {n: a + w * g[n].float() for n, a in g_acc.items()}
        div = accum if even else 1
        loss_acc = loss_acc / div
        grads = {n: (a / div).to(dtypes[n]) for n, a in g_acc.items()}
        aux = (tree_map(lambda *xs: torch.stack(xs), auxs[0], *auxs[1:])
               if has_aux else None)
        return loss_acc, aux, grads
    return vg_accum


def merge_metrics(metrics: Dict, extra: Dict) -> Dict:
    """Merge user metrics, refusing to clobber the framework's keys."""
    overlap = set(metrics) & set(extra)
    if overlap:
        raise ValueError(
            f"metrics_fn returned reserved metric key(s) {sorted(overlap)}; "
            "rename them — 'loss' and 'aux' are produced by the step itself")
    out = dict(metrics)
    out.update(extra)
    return out


def plain_schedule_ir(gi, compiled):
    """The plain step's schedule IR: ``ir_from_facts`` over the trainable
    variables' plans, the JAX GSPMD step's IR (``graph_transformer.py:
    384-400``): one per-variable reduction each (the step itself packs
    them into all-reduce buckets at data size > 1, the same sums), the
    guard's roll-up when the guard is on, no fused kernel (its guard runs
    per variable, unfused)."""
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    d = compiled.mesh.data_size
    infos = {v.name: v for v in gi.info.variables}
    facts = [sir.fact_from_varplan(plan, infos[name], d)
             for name, plan in compiled.var_plans.items()
             if name in infos and infos[name].trainable]
    axes = {str(a): int(n) for a, n in compiled.mesh.shape.items()}
    num_cfg = gi.numerics
    return sir.ir_from_facts(
        facts, axes=axes, accum_steps=gi.accum_steps,
        guard=bool(num_cfg is not None and num_cfg.guard),
        moe=sir.moe_facts_from_vars(gi.info.variables, axes=axes))


def lowered_schedule_ir(gi, compiled):
    """``(ir, fused drops)``: the schedule IR of the step ``compiled``
    lowers ``gi`` to, the explicit bucketed step's or the plain one's,
    without building the step (what the analyzer checks)."""
    from autodist_tpu_torch.kernel.synchronization import explicit_sync

    if explicit_sync.uses_explicit_path(compiled):
        sp = explicit_sync.plan_step(gi, compiled)
        return sp.ir, sp.fused_drops
    return plain_schedule_ir(gi, compiled), []


class GraphTransformer:
    """Builds a :class:`DistributedStep` from strategy + program."""

    def __init__(self, compiled_strategy, graph_item):
        self.compiled = compiled_strategy
        self.graph_item = graph_item

    def transform(self, extra_metrics_fn: Optional[Callable] = None
                  ) -> DistributedStep:
        step = self._lower(extra_metrics_fn)
        step.compiled_strategy = self.compiled
        return step

    def _lower(self, extra_metrics_fn: Optional[Callable]
               ) -> DistributedStep:
        gi = self.graph_item
        if gi.optimizer is None or gi.loss_fn is None:
            raise ValueError(
                "GraphItem must carry an optimizer and loss_fn to transform "
                "(capture them via AutoDist.capture)")
        from autodist_tpu_torch.kernel.synchronization import explicit_sync

        check_seq_program(gi, self.compiled.mesh)
        check_grad_fn_program(gi, self.compiled)
        # a variable whose model sharding is dropped is replicated, with
        # the JAX package's warning, on either step
        explicit_sync.partition_support(gi, self.compiled, warn=True)
        if explicit_sync.uses_explicit_path(self.compiled):
            return explicit_sync.make_explicit_step(gi, self.compiled,
                                                    extra_metrics_fn)
        from autodist_tpu_torch.kernel.synchronization import schedule_ir

        sched = plain_schedule_ir(gi, self.compiled)
        schedule_ir.assert_verified(sched, "plain build")
        mesh = self.compiled.mesh
        data, group, rank = mesh.data_size, mesh.data_group, mesh.data_rank
        names = tuple(v.name for v in gi.info.trainable_variables)
        buckets: Tuple[Bucket, ...] = ()
        if data > 1:
            plans = self.compiled.var_plans
            buckets = tuple(assign_buckets([
                (v.name, v.shape, v.dtype, plans[v.name].compressor,
                 plans[v.name].group, MODE_ALL_REDUCE)
                for v in gi.info.trainable_variables]))
        has_aux, optimizer = gi.has_aux, gi.optimizer
        num_cfg = gi.numerics
        num_active = num_cfg is not None and num_cfg.guard
        num_ls = resolve_grad_fn_loss_scale(gi, ls_mod.resolve_loss_scale(
            num_cfg.loss_scale, [v.dtype for v in gi.info.variables])) \
            if num_active else None
        vg_unscaled = scaled_value_and_grad(gi, names, None)
        warned: List[int] = []
        seq = mesh_seq_chunk(mesh)
        inject = chaos_injector(gi, num_active, buckets, names)

        def sync(loss, grads):
            for bucket in buckets:
                vec = pack_bucket(bucket, [grads[n] for n in bucket.names])
                vec = coll.all_reduce(vec, group) / data
                grads.update(zip(bucket.names, unpack_bucket(bucket, vec)))
            return coll.all_reduce(loss, group) / data

        def step(params, opt_state, sync_state, batch):
            scale = sync_state[NUMERICS_KEY]["scale"] \
                if num_ls is not None else None
            vg = vg_unscaled if scale is None and inject is None \
                else scaled_value_and_grad(
                    gi, names, scale,
                    inject=inject(sync_state) if inject else None)
            loss, aux, grads = local_value_and_grad(vg, params, batch, data,
                                                    group, rank, warned, seq)
            if data > 1:
                loss = sync(loss, grads)
            metrics: Dict[str, Any] = {}
            ok = True
            if num_active:
                # the guard over the averaged gradients: per variable,
                # unfused, no collective (the values are already global)
                health = guard_mod.HealthAccumulator(1)
                for n in names:
                    health.add(n, grads[n])
                all_finite, gnorm, per_bucket, inv_scale, mult = \
                    guard_mod.rollup(health, None, loss, scale,
                                     num_cfg.clip_norm)
                ok = bool(all_finite)   # the skip gate's one host sync
                if ok and mult is not None:
                    for g in grads.values():
                        g.mul_(mult)
            if ok:
                optimizer.step_(params, grads, opt_state)
            if num_active:
                metrics["grad_health"] = guard_mod.close_step(
                    sync_state, all_finite, gnorm, per_bucket, num_ls)
                if scale is not None:
                    loss = loss * inv_scale
            metrics["loss"] = loss
            if aux is not None:
                metrics["aux"] = aux
            if extra_metrics_fn is not None:
                with torch.no_grad():
                    metrics = merge_metrics(
                        metrics, extra_metrics_fn(params, batch))
            return metrics

        def init_fn(params):
            leaves = dict(flatten(params))
            return optimizer.init(unflatten([(n, leaves[n].detach())
                                             for n in names]))

        return DistributedStep(
            step_fn=step, init_fn=init_fn,
            eval_fn=make_eval_step(gi.loss_fn, has_aux, extra_metrics_fn),
            mesh=mesh, trainable=names, buckets=buckets,
            init_sync_state=sync_state_init(num_active, num_ls, mesh.device),
            schedule_ir=sched)


def scaled_loss(gi, scale: Optional[torch.Tensor]) -> Callable:
    """The captured loss, multiplied by ``scale`` (the loss scale) when
    one is given."""
    if scale is None:
        return gi.loss_fn

    def loss_fn(p, b):
        out = gi.loss_fn(p, b)
        if gi.has_aux:
            return out[0] * scale, out[1]
        return out * scale
    return loss_fn


def chaos_injector(gi, num_active: bool, buckets: Sequence,
                   names: Sequence[str]) -> Optional[Callable]:
    """The step's chaos gradient injection, resolved when the step is
    built: ``inject(sync_state)`` gives the wrapper of the per-microbatch
    ``vg`` (keyed on the numerics state's device step counter), or None
    when ``AUTODIST_CHAOS`` asks for no ``nan_grad``/``inf_grad`` here.
    Without the numerics guard a requested injection warns and is
    ignored, as in the JAX package."""
    from autodist_tpu_torch.kernel.synchronization.explicit_sync import \
        chaos_grad_events_probe

    if not num_active:
        if list(chaos_grad_events_probe()):
            warnings.warn("AUTODIST_CHAOS requests a gradient injection "
                          "but the numerics guard is off — nan_grad/"
                          "inf_grad need capture(numerics=...); ignoring "
                          "the event")
        return None
    injections = guard_mod.resolve_injections(buckets, names)
    if not injections:
        return None
    return lambda sync_state: (lambda vg: guard_mod.wrap_injections(
        vg, injections, sync_state[NUMERICS_KEY]["step"]))


def scaled_value_and_grad(gi, names: Tuple[str, ...],
                          scale: Optional[torch.Tensor],
                          inject: Optional[Callable] = None) -> Callable:
    """``vg(params, batch) -> (loss, aux, {name: grad})`` of the captured
    loss, multiplied by ``scale`` before the backward pass when one is
    given (the loss scale), accumulated over ``accum_steps``
    microbatches.  ``inject`` wraps the per-microbatch ``vg`` before the
    accumulation (the chaos gradient injection: scale, then injection,
    then accumulation).  A captured ``grad_fn`` replaces autograd (and
    takes no scale: :func:`resolve_grad_fn_loss_scale`)."""
    vg = manual_value_and_grad(gi.grad_fn, names) \
        if gi.grad_fn is not None \
        else value_and_grad(scaled_loss(gi, scale), gi.has_aux, names)
    if inject is not None:
        vg = inject(vg)
    if gi.accum_steps > 1:
        vg = accumulate(vg, gi.accum_steps, gi.has_aux)
    return vg


def make_eval_step(loss_fn: Callable, has_aux: bool,
                   extra_metrics_fn: Optional[Callable] = None) -> Callable:
    """``eval(params, batch) -> metrics``: loss (and aux, and the
    ``metrics_fn`` extras) on the current parameters, no state change."""
    @torch.no_grad()
    def eval_step(params, batch):
        if has_aux:
            loss, aux = loss_fn(params, batch)
            out = {"loss": loss, "aux": aux}
        else:
            out = {"loss": loss_fn(params, batch)}
        if extra_metrics_fn is not None:
            out = merge_metrics(out, extra_metrics_fn(params, batch))
        return out
    return eval_step
