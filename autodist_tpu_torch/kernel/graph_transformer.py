"""GraphTransformer: lower the captured program into a distributed step.

Port of the JAX package's ``kernel/graph_transformer.py`` for this slice's
path, the twin of its GSPMD step (``:402-493``) reduced to replicated
AllReduce plans.  One step runs, in order:

1. loss and gradients: ``loss_fn`` under autograd on this rank's rows of
   the global batch (its slice of the ``data`` axis);
2. accumulation: with ``accum_steps > 1`` the gradients are averaged over
   microbatches in f32 — the even split of ``_accumulate_grads`` or the
   row-weighted uneven tail of ``_uneven_accumulate``;
3. data-parallel sync: when ``data`` is wider than 1, one ``all_reduce``
   per bucket of :func:`~autodist_tpu_torch.kernel.synchronization.
   bucketing.assign_buckets`' plan, then the mean over the data group
   (NCCL on the card, gloo on CPU ranks); at width 1 there is no
   collective;
4. the optimizer update, in place under ``torch.no_grad()``; frozen
   variables get no gradient, no update and no state;
5. metrics: ``{"loss"}``, plus ``aux`` and the ``metrics_fn`` extras
   (computed on the updated parameters and the global batch).

The options that need the explicit bucketed step or the PS family raise,
naming their ROADMAP item; nothing runs in place of what was asked.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch.const import not_ported
from autodist_tpu_torch.graph_item import flatten, tree_map, unflatten
from autodist_tpu_torch.kernel.synchronization.bucketing import (
    MODE_ALL_REDUCE, Bucket, assign_buckets, pack_bucket, unpack_bucket)


@dataclass
class DistributedStep:
    """The lowered step and what running it needs.

    ``step_fn(params, opt_state, batch) -> metrics`` updates ``params`` and
    ``opt_state`` in place; ``batch`` is the placed GLOBAL batch.
    ``eval_fn(params, batch) -> metrics`` changes nothing."""

    step_fn: Callable
    init_fn: Callable            # params -> optimizer state
    eval_fn: Callable
    mesh: Any
    trainable: Tuple[str, ...]
    buckets: Tuple[Bucket, ...] = ()

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def place_params(self, params):
        """A copy of ``params`` (tensors or numpy arrays) on the mesh's
        device; trainable leaves require grad.  The caller's tensors are
        never updated in place."""
        named = []
        for name, leaf in flatten(params):
            t = torch.as_tensor(leaf).detach().to(self.device).clone()
            named.append((name, t.requires_grad_(name in self.trainable)))
        return unflatten(named)

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


def _refuse_unported(compiled) -> None:
    for name, plan in compiled.var_plans.items():
        if plan.compressor not in ("", "NoneCompressor"):
            raise not_ported(f"compressor {plan.compressor!r} ({name})",
                             "P6 — compressors and fused groups")
        if plan.fused:
            raise not_ported(f"fused_groups ({name})",
                             "P6 — compressors and fused groups")
        if plan.sync_mode != MODE_ALL_REDUCE:
            raise not_ported(f"sync={plan.sync_mode!r} ({name})",
                             "slice 3 — the PS family and Zero1")
        if plan.bucket_bytes:
            raise not_ported(f"bucket_bytes={plan.bucket_bytes} ({name})",
                             "slice 3 — the explicit bucketed step")
        if plan.overlap not in ("auto", "none"):
            raise not_ported(f"overlap={plan.overlap!r} ({name})",
                             "P6 — overlap, hier and staleness")
        if plan.hier:
            raise not_ported(f"hier=True ({name})",
                             "P6 — overlap, hier and staleness")


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


def _value_and_grad(loss_fn: Callable, has_aux: bool, names: Tuple[str, ...]):
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


def _accumulate(vg: Callable, accum: int, has_aux: bool):
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


def _merge_metrics(metrics: Dict, extra: Dict) -> Dict:
    """Merge user metrics, refusing to clobber the framework's keys."""
    overlap = set(metrics) & set(extra)
    if overlap:
        raise ValueError(
            f"metrics_fn returned reserved metric key(s) {sorted(overlap)}; "
            "rename them — 'loss' and 'aux' are produced by the step itself")
    out = dict(metrics)
    out.update(extra)
    return out


class GraphTransformer:
    """Builds a :class:`DistributedStep` from strategy + program."""

    def __init__(self, compiled_strategy, graph_item):
        self.compiled = compiled_strategy
        self.graph_item = graph_item

    def transform(self, extra_metrics_fn: Optional[Callable] = None
                  ) -> DistributedStep:
        gi = self.graph_item
        if gi.optimizer is None or gi.loss_fn is None:
            raise ValueError(
                "GraphItem must carry an optimizer and loss_fn to transform "
                "(capture them via AutoDist.capture)")
        _refuse_unported(self.compiled)
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
        loss_fn, has_aux, optimizer = gi.loss_fn, gi.has_aux, gi.optimizer
        vg = _value_and_grad(loss_fn, has_aux, names)
        if gi.accum_steps > 1:
            vg = _accumulate(vg, gi.accum_steps, has_aux)
        warned: List[int] = []

        def local_rows(batch):
            if data == 1:
                return batch
            n = _leading_dim(batch)
            if n % data:
                if n not in warned:
                    warned.append(n)
                    warnings.warn(
                        f"batch with leading dim {n} is not divisible by the "
                        f"data axis (size {data}); every rank runs the whole "
                        f"batch — pad the global batch for data parallelism")
                return batch
            return _rows(batch, rank * (n // data), n // data)

        def sync(loss, grads):
            for bucket in buckets:
                vec = pack_bucket(bucket, [grads[n] for n in bucket.names])
                dist.all_reduce(vec, group=group)
                vec.div_(data)
                grads.update(zip(bucket.names, unpack_bucket(bucket, vec)))
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            return loss / data

        def step(params, opt_state, batch):
            loss, aux, grads = vg(params, local_rows(batch))
            if data > 1:
                loss = sync(loss, grads)
            optimizer.step_(params, grads, opt_state)
            metrics = {"loss": loss}
            if aux is not None:
                metrics["aux"] = aux
            if extra_metrics_fn is not None:
                with torch.no_grad():
                    metrics = _merge_metrics(
                        metrics, extra_metrics_fn(params, batch))
            return metrics

        @torch.no_grad()
        def eval_step(params, batch):
            if has_aux:
                loss, aux = loss_fn(params, batch)
                out = {"loss": loss, "aux": aux}
            else:
                out = {"loss": loss_fn(params, batch)}
            if extra_metrics_fn is not None:
                out = _merge_metrics(out, extra_metrics_fn(params, batch))
            return out

        def init_fn(params):
            leaves = dict(flatten(params))
            return optimizer.init(unflatten([(n, leaves[n].detach())
                                             for n in names]))

        return DistributedStep(step_fn=step, init_fn=init_fn,
                               eval_fn=eval_step, mesh=mesh,
                               trainable=names, buckets=buckets)
