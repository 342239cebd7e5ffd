"""Pipeline parallelism: microbatched ring schedules over the ``pipe`` axis.

Port of ``autodist_tpu/parallel/pipeline.py``.  Stage parameters are
*stacked*: every stage-local parameter carries a leading ``[S·V]`` stage
axis (``S`` stages, ``V`` chunks a stage), cut over the ``pipe`` axis,
so the strategy layer sees ordinary variables whose plan leads with
``pipe`` (``strategy/compiler.py``).  One tick formula covers GPipe
(``V = 1``: ``M + S - 1`` ticks, bubble ``(S-1)/(M+S-1)``) and the
interleaved schedule (``V > 1``, the Megatron-LM circular schedule: global
stage ``v·S + d`` on rank ``d``, ``M·V + S - 1`` ticks of ``1/V``-size
work).

The JAX package runs the tick loop as one ``lax.scan`` inside
``shard_map`` over ``pipe`` and differentiates through it.  Here every
rank of the pipe group runs the same tick loop eagerly on its own chunks
(rank ``d`` holds rows ``d·V … d·V + V - 1`` of the stored device-major
stack): stage 0 injects a microbatch when an empty ring slot arrives,
the last stage banks finished ones, and after every tick the activation
moves one hop along the ring (``collectives.ring_shift``, the
``ppermute``).  A rank computes only on the ticks where it holds a
microbatch: on the others it sends zeros, the slot it would have
computed on being one the JAX package computes on and throws away.  The
output is the last stage's bank, replicated over the pipe group by one
masked ``all_reduce``.

The backward is the loop's own (:class:`_Pipeline`, one
``autograd.Function``), so that its collectives run in the same order on
every rank whatever autograd's order: the ticks in reverse, each active
tick's stage graph (kept from the forward, or recomputed under
``remat``) differentiated with ``torch.autograd.grad``, the cotangent
moving one hop back along the ring every tick.  The construction keeps
every gradient equal to one card's: the output's cotangent is taken by
the last stage alone (every pipe rank computes the same loss from the
replicated output: an all-reduce there would count it ``S`` times), and
the input's gradient, produced on stage 0, is summed over the pipe group,
so the layers before the pipeline get it whole on every rank.

Inside a step (``pipe`` in :func:`~autodist_tpu_torch.mesh.
current_manual_axes`), the stage leaves are this rank's ``[V, ...]``
chunks already (the bucketed step keeps a stage stack cut over
``pipe``); outside one (evaluate, a direct call) they are the whole
device-major ``[S·V, ...]`` stack, of which the rank takes its rows with
a differentiable slice (its backward gathers every rank's rows, so the
stack's gradient is whole on every rank, as for a replicated value).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from autodist_tpu_torch.const import MESH_AXIS_PIPE
from autodist_tpu_torch.graph_item import flatten, rematerialize, unflatten
from autodist_tpu_torch.kernel.synchronization import collectives as coll
from autodist_tpu_torch.mesh import current_manual_axes


def interleaved_stage_order(num_stages: int, num_virtual_stages: int
                            ) -> Tuple[int, ...]:
    """Device-major permutation of pipeline-order stage indices: entry
    ``d·V + v`` is global stage ``v·S + d``, so the contiguous ``pipe``
    cut of the stored stack puts each rank's V chunks on it.  Apply it
    to a pipeline-ordered stage list before :func:`stack_stage_params`."""
    s, v = num_stages, num_virtual_stages
    return tuple(vv * s + d for d in range(s) for vv in range(v))


def schedule_ticks(num_stages: int, num_microbatches: int,
                   num_virtual_stages: int = 1) -> int:
    """Total ring ticks the schedule takes: the last microbatch (index
    ``M-1``) is injected at tick ``((M-1)//S)·S·V + (M-1)%S`` and exits
    ``S·V`` ticks later."""
    s, m, v = num_stages, num_microbatches, num_virtual_stages
    return ((m - 1) // s) * s * v + ((m - 1) % s) + s * v


def bubble_fraction(num_stages: int, num_microbatches: int,
                    num_virtual_stages: int = 1) -> float:
    """Idle fraction of the schedule: ``1 - M·V / ticks``."""
    t = schedule_ticks(num_stages, num_microbatches, num_virtual_stages)
    return 1.0 - (num_microbatches * num_virtual_stages) / t


def default_num_microbatches(num_stages: int, batch: int) -> int:
    """The largest microbatch count ``<= 4·S`` that divides ``batch``."""
    m = min(4 * num_stages, batch)
    while batch % m:
        m -= 1
    return m


def stack_stage_params(per_stage_params) -> Any:
    """Stack a list of per-stage trees (nested dicts of tensors, or
    tensors) into one tree with a leading ``[S]`` (or ``[S·V]``) axis, in
    list order."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack([torch.as_tensor(p) for p in per_stage_params])


def tree_leaves(tree) -> Tuple[List[str], List[torch.Tensor]]:
    """``(names, leaves)`` of a nested dict of tensors (catalog order), or
    ``([""], [tree])`` for one tensor."""
    if isinstance(tree, dict):
        named = flatten(tree)
        return [n for n, _ in named], [x for _, x in named]
    return [""], [tree]


def tree_build(names: List[str], leaves) -> Any:
    """The tree :func:`tree_leaves` took apart, from new leaves."""
    if names == [""]:
        return leaves[0]
    return unflatten(list(zip(names, leaves)))


def stage_slot(t: int, d: int, s: int, v: int) -> Tuple[int, int, int]:
    """``(chunk, microbatch, injection tick)`` of the ring slot rank ``d``
    holds at tick ``t`` (the JAX package's ``_chunk_at``): chunk
    ``((t - d) mod S·V) // S`` at global stage ``chunk·S + d``, of the
    microbatch injected at tick ``t - stage`` (an index ``>= M`` or a
    negative tick is an empty slot)."""
    period = s * v
    chunk = ((t - d) % period) // s
    tj = t - (chunk * s + d)
    return chunk, (tj // period) * s + tj % period, tj


def local_stages(leaves, mesh, axis_name: str, s: int, v: int,
                 differentiable: bool):
    """This rank's ``[V, ...]`` chunks of each stage leaf: the leaves as
    they are inside a step, else rows ``d·V … d·V + V - 1`` of the whole
    ``[S·V, ...]`` stack (through :func:`~autodist_tpu_torch.kernel.
    synchronization.collectives.slice_replicated` when
    ``differentiable``)."""
    manual = axis_name in current_manual_axes()
    want = v if manual else s * v
    for leaf in leaves:
        if leaf.shape[0] != want:
            where = (f"this rank's {v} virtual stages (inside a step)"
                     if manual else f"pipe axis size {s} x {v} virtual "
                     f"stages")
            raise ValueError(
                f"stage_params leading dim {leaf.shape[0]} != {where}")
    if manual:
        return list(leaves)
    group, d = mesh.axis_group(axis_name), mesh.axis_rank(axis_name)
    if differentiable:
        return [coll.slice_replicated(x, group, 0) for x in leaves]
    return [x[d * v:(d + 1) * v] for x in leaves]


class _Schedule:
    """The GPipe / interleaved tick loop of one rank: its forward, which
    keeps each active tick's stage graph when ``graph``, and the
    backward over those graphs."""

    def __init__(self, stage_fn: Callable, names: List[str], s: int,
                 v: int, m: int, rank: int, group):
        self.fn, self.names = stage_fn, names
        self.s, self.v, self.m, self.d, self.group = s, v, m, rank, group
        self.ticks = schedule_ticks(s, m, v)
        self.records = {}
        self.chunks: List[List[torch.Tensor]] = []

    def forward(self, x: torch.Tensor, leaves, graph: bool) -> torch.Tensor:
        s, v, m, d = self.s, self.v, self.m, self.d
        mb = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        if graph:
            self.chunks = [[p.detach()[c].detach().requires_grad_(
                p.requires_grad) for p in leaves] for c in range(v)]
        else:
            self.chunks = [[p[c] for p in leaves] for c in range(v)]
        zero = torch.zeros_like(mb[0])
        bank = torch.zeros_like(mb)
        a_in = zero
        ctx = torch.enable_grad() if graph else contextlib.nullcontext()
        for t in range(self.ticks):
            chunk, j, tj = stage_slot(t, d, s, v)
            send = zero
            if tj >= 0 and j < m:
                a = mb[j] if d == 0 and chunk == 0 else a_in
                if graph:
                    a = a.detach().requires_grad_()
                with ctx:
                    y = self.fn(tree_build(self.names, self.chunks[chunk]), a)
                if graph:
                    self.records[t] = (chunk, j, a, y)
                    y = y.detach()
                if d == s - 1 and chunk == v - 1:
                    bank[j] = y
                send = y
            if t < self.ticks - 1:
                a_in = coll.ring_shift(send, self.group, 1).view(send.shape)
        if d != s - 1:
            bank.zero_()
        return coll.all_reduce(bank, self.group).reshape(
            (x.shape[0],) + tuple(bank.shape[2:]))

    def backward(self, g_out: torch.Tensor, x_shape):
        s, v, m, d = self.s, self.v, self.m, self.d
        g_mb = g_out.reshape((m, g_out.shape[0] // m)
                             + tuple(g_out.shape[1:]))
        zero = torch.zeros_like(g_mb[0])
        dx = torch.zeros_like(g_mb)
        dp: List[List[Optional[torch.Tensor]]] = [
            [None] * len(self.names) for _ in range(v)]
        g_recv = zero
        for t in reversed(range(self.ticks)):
            send = zero
            rec = self.records.pop(t, None)
            if rec is not None:
                chunk, j, a, y = rec
                gy = g_recv + g_mb[j] if d == s - 1 and chunk == v - 1 \
                    else g_recv
                want = [a] + [p for p in self.chunks[chunk]
                              if p.requires_grad]
                got = iter(torch.autograd.grad(y, want, gy.to(y.dtype),
                                               allow_unused=True))
                ga = next(got)
                for i, p in enumerate(self.chunks[chunk]):
                    if not p.requires_grad:
                        continue
                    g = next(got)
                    if g is not None:
                        acc = dp[chunk][i]
                        dp[chunk][i] = g if acc is None else acc + g
                ga = torch.zeros_like(a) if ga is None else ga
                if d == 0 and chunk == 0:
                    dx[j] = ga          # the injected microbatch's
                else:
                    send = ga.to(zero.dtype)
            if t > 0:
                g_recv = coll.ring_shift(send, self.group, -1).view(
                    send.shape)
        if d != 0:
            dx.zero_()
        dx = coll.all_reduce(dx, self.group).reshape(x_shape)
        grads = []
        for i in range(len(self.names)):
            parts = [dp[c][i] if dp[c][i] is not None
                     else torch.zeros_like(self.chunks[c][i])
                     for c in range(v)]
            grads.append(torch.stack(parts))
        self.chunks = []
        return dx, grads


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, x, *leaves):
        ctx.sched, ctx.x_shape = sched, tuple(x.shape)
        return sched.forward(x, leaves, graph=True)

    @staticmethod
    def backward(ctx, g):
        dx, grads = ctx.sched.backward(g.contiguous(), ctx.x_shape)
        needs = ctx.needs_input_grad
        return (None, dx if needs[1] else None,
                *[gr if need else None for gr, need in zip(grads,
                                                          needs[2:])])


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   mesh, *, num_microbatches: Optional[int] = None,
                   num_virtual_stages: int = 1, remat: bool = False,
                   axis_name: str = MESH_AXIS_PIPE) -> torch.Tensor:
    """Apply a pipeline of stacked stages to a batch.

    ``stage_fn(params_one_stage, x_microbatch) -> y_microbatch``, ``y``
    shaped like ``x``.  ``stage_params``: a tree (nested dicts of tensors,
    or one tensor) whose leaves lead with the stage axis, pipeline order
    for V = 1, device-major for V > 1 (:func:`interleaved_stage_order`):
    the whole ``[S·V, ...]`` stack outside a step, this rank's ``[V,
    ...]`` inside one.  ``x``: the batch ``[B, ...]`` (this data rank's
    rows inside a step); it must divide into ``num_microbatches``
    (default :func:`default_num_microbatches`).  ``remat``
    rematerializes each stage application in the backward
    (``graph_item.rematerialize``).  At ``pipe`` size 1 the stages run
    as a plain loop over the stage dimension (the device-major order is
    pipeline order there).  Returns ``[B, ...]``, replicated over the
    pipe group."""
    s = int(mesh.shape.get(axis_name, 1)) if mesh is not None else 1
    v = num_virtual_stages
    fn = rematerialize(stage_fn, "full") if remat else stage_fn
    names, leaves = tree_leaves(stage_params)
    if s <= 1:
        h = x
        for i in range(leaves[0].shape[0]):
            h = fn(tree_build(names, [p[i] for p in leaves]), h)
        return h
    b = x.shape[0]
    m = num_microbatches or default_num_microbatches(s, b)
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    grad = torch.is_grad_enabled() and (x.requires_grad or any(
        p.requires_grad for p in leaves))
    chunks = local_stages(leaves, mesh, axis_name, s, v, grad)
    group = mesh.axis_group(axis_name)
    sched = _Schedule(fn, names, s, v, m, dist.get_rank(group), group)
    if not grad:
        with torch.no_grad():
            return sched.forward(x, chunks, graph=False)
    return _Pipeline.apply(sched, x, *chunks)
