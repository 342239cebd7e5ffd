"""The data axis's collectives, one function per primitive.

The JAX package writes its sync layer with ``lax`` collectives over a mesh
axis: ``ppermute`` with the ring permutation ``i -> i + 1``,
``all_to_all``, ``all_gather``, ``psum_scatter`` and ``psum``.  These are
their counterparts over a ``torch.distributed`` process group, on flat
tensors:

* :func:`ring_shift` — ``ppermute`` by one: send to rank ``r + 1``,
  receive from ``r - 1`` (``batch_isend_irecv``);
* :func:`all_to_all` — ``all_to_all_single``, equal splits;
* :func:`all_gather` — ``all_gather_into_tensor``, rank-major;
* :func:`reduce_scatter` — ``reduce_scatter_tensor``, summed;
* :func:`all_reduce` — ``all_reduce``, summed.

:func:`ppermute`, :func:`all_to_all_tiled` and :func:`all_gather_tiled`
are their differentiable forms on tensors of any shape, for the seq axis's
attention: the backward of a ring shift is the reverse shift (JAX
transposes ``ppermute`` so), that of an ``all_to_all`` the inverse
``all_to_all``, that of an ``all_gather`` the ``psum_scatter`` of the
cotangent.

The model and expert axes' gather and slice: :func:`gather_shards`
joins every rank's shard of a variable along its sharded dim over that
axis's group (the bucketed step's gather of a model-sharded parameter,
or of an MoE expert stack along its leading dim, before the loss, and of
its moments for a logical export), :func:`shard_of` cuts this rank's
shard back out.  The MoE FFN outside a step crosses the expert group by
:func:`all_to_all_tiled` and gathers its output with
:func:`gather_replicated`.
:func:`gather_replicated` and :func:`slice_replicated` are their
differentiable forms for values REPLICATED over the group (every rank
holds the same full tensor and the same cotangent of it, as q, k, v and
the attention output of ``make_flash_attention(mesh)`` are): the gather's
backward takes this rank's part of the cotangent (a ``psum_scatter``
would add the replicas' copies), the slice's backward gathers the parts,
so every rank gets the full gradient it would get without the group.

A collective over a part of the ranks (``axis_index_groups`` in ``lax``:
the ``within`` and ``across`` groups of ``hier`` sync) runs over a
process group of its own, made once per step by :func:`subgroups`.
:func:`all_reduce_async` / :func:`reduce_scatter_async` issue a
collective and return a :class:`Pending` whose ``wait()`` gives the
result, so the accumulation pipeline can run the next microbatch's
backward while the collective is in flight.

NCCL moves device tensors directly.  gloo has no device-side transport:
a CUDA tensor crosses a gloo group through a copy to the host and back
(four ranks sharing one card run so; their kernels still run on the
card).  The branch is chosen from ``dist.get_backend(group)``; the
host-staged branch is synchronous, an asynchronous call on it returns a
finished :class:`Pending`.  One-byte wire formats (int8, fp8) travel as
``uint8`` bits.  Every function returns a new tensor and leaves its input
as it was.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _host_staged(group, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the tensor the backend moves: one-byte floats as uint8."""
    if t.element_size() == 1 and t.dtype not in (torch.int8, torch.uint8):
        return t.view(torch.uint8)
    return t


class Pending:
    """An issued collective: :meth:`wait` blocks until it is done and
    returns its result."""

    def __init__(self, work, out: torch.Tensor, finish):
        self._work, self._out, self._finish = work, out, finish

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._finish(self._out)

    def then(self, fn) -> "Pending":
        """This collective, its result passed through ``fn``."""
        finish = self._finish
        return Pending(self._work, self._out, lambda o: fn(finish(o)))


def done(value: torch.Tensor) -> Pending:
    """A finished :class:`Pending` holding ``value``."""
    return Pending(None, value, lambda o: o)


def _issue(group, t: torch.Tensor, out_numel: int, op,
           async_op: bool) -> Pending:
    """``op(out, src, async_op)`` on a fresh output of ``out_numel``
    elements, on the host (and synchronously) when the group cannot move
    ``t``'s device memory."""
    src = _bits(t.contiguous()).reshape(-1)
    staged = _host_staged(group, src)
    if staged:
        src = src.cpu()
    out = src.new_empty(out_numel)
    work = op(out, src, async_op and not staged)

    def finish(o):
        o = o.to(t.device) if o.device != t.device else o
        return o.view(t.dtype) if o.dtype != t.dtype else o
    return Pending(work, out, finish)


def _run(group, t: torch.Tensor, out_numel: int, op) -> torch.Tensor:
    """``op(out, src)`` on a fresh output of ``out_numel`` elements, on
    the host when the group cannot move ``t``'s device memory."""
    return _issue(group, t, out_numel,
                  lambda out, src, _: op(out, src), False).wait()


def subgroups(group, rank_lists):
    """One process group per list of ranks of ``group`` (every rank makes
    every group, in the same order, as ``dist.new_group`` requires);
    returns the one holding this rank, or None when none does."""
    mine = None
    me = dist.get_rank(group)
    for ranks in rank_lists:
        sub = dist.new_group(ranks=[dist.get_global_rank(group, r)
                                    for r in ranks])
        if me in ranks:
            mine = sub
    return mine


def ring_shift(t: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """``lax.ppermute(t, perm=[(i, i + step mod n)])``: this rank's ``t``
    goes to rank ``r + step``; returns what rank ``r - step`` sent."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + step) % n)
    prv = dist.get_global_rank(group, (r - step) % n)

    def op(out, src):
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, nxt, group),
            dist.P2POp(dist.irecv, out, prv, group)])
        for req in reqs:
            req.wait()
    return _run(group, t, t.numel(), op)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_to_all`` of a flat ``t`` cut into ``n`` equal chunks:
    chunk ``j`` goes to rank ``j``; returns the ``n`` chunks received,
    rank-major."""
    return _run(group, t, t.numel(), lambda out, src:
                dist.all_to_all_single(out, src, group=group))


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``: every rank's ``t``, rank-major."""
    n = dist.get_world_size(group)
    return _run(group, t, n * t.numel(), lambda out, src:
                dist.all_gather_into_tensor(out, src, group=group))


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum_scatter(tiled=True)``: this rank's ``1/n`` chunk of the
    sum of every rank's ``t``."""
    n = dist.get_world_size(group)
    return _run(group, t, t.numel() // n, lambda out, src:
                dist.reduce_scatter_tensor(out, src, group=group))


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(t, group, False).wait()


def all_reduce_async(t: torch.Tensor, group) -> Pending:
    """:func:`all_reduce`, issued; ``wait()`` gives the sum."""
    return _all_reduce(t, group, True)


def _all_reduce(t: torch.Tensor, group, async_op: bool) -> Pending:
    def op(out, src, asynchronous):
        out.copy_(src)
        return dist.all_reduce(out, group=group, async_op=asynchronous)
    return _issue(group, t, t.numel(), op, async_op).then(
        lambda o: o.view(t.shape))


def reduce_scatter_async(t: torch.Tensor, group) -> Pending:
    """:func:`reduce_scatter`, issued; ``wait()`` gives this rank's
    chunk of the sum."""
    n = dist.get_world_size(group)
    return _issue(group, t, t.numel() // n, lambda out, src, async_op:
                  dist.reduce_scatter_tensor(out, src, group=group,
                                             async_op=async_op), True)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, step):
        ctx.group, ctx.step = group, step
        return ring_shift(t, group, step).view(t.shape)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, ctx.group, -ctx.step).view(g.shape), None, None


def ppermute(t: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """:func:`ring_shift` of ``t`` (any shape), differentiable: the
    cotangent travels the ring the other way."""
    return _PPermute.apply(t, group, step)


def _all_to_all_tiled(x: torch.Tensor, group, split_axis: int,
                      concat_axis: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    chunks = x.movedim(split_axis, 0)
    chunks = chunks.reshape((n, chunks.shape[0] // n) + chunks.shape[1:])
    got = all_to_all(chunks, group).view(chunks.shape)
    # got[j] is rank j's chunk: back to x's layout, then joined along
    # concat_axis in rank order
    return torch.cat([c.movedim(0, split_axis) for c in got.unbind(0)],
                     dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all_tiled(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return (_all_to_all_tiled(g, group, concat_axis, split_axis), None,
                None, None)


def all_to_all_tiled(x: torch.Tensor, group, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=, concat_axis=, tiled=True)``,
    differentiable: ``x`` cut into ``n`` equal chunks along
    ``split_axis``, chunk ``j`` sent to rank ``j``, the chunks received
    joined along ``concat_axis`` in rank order.  Its backward is the
    inverse ``all_to_all``."""
    if x.shape[split_axis] % dist.get_world_size(group):
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not divide over "
                         f"{dist.get_world_size(group)} ranks")
    return _AllToAll.apply(x, group, split_axis, concat_axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        n = dist.get_world_size(group)
        moved = x.movedim(axis, 0).contiguous()
        out = all_gather(moved, group).view((n * moved.shape[0],)
                                            + moved.shape[1:])
        return out.movedim(0, axis)

    @staticmethod
    def backward(ctx, g):
        moved = g.movedim(ctx.axis, 0).contiguous()
        n = dist.get_world_size(ctx.group)
        mine = reduce_scatter(moved, ctx.group).view(
            (moved.shape[0] // n,) + moved.shape[1:])
        return mine.movedim(0, ctx.axis), None, None


def all_gather_tiled(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """``lax.all_gather(x, axis=, tiled=True)``, differentiable: every
    rank's ``x`` joined along ``axis`` in rank order; its backward is the
    ``psum_scatter`` of the cotangent (this rank's part of the sum)."""
    return _AllGather.apply(x, group, axis)


def gather_shards(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """``lax.all_gather(x, axis=, tiled=True)``, not differentiable: every
    rank's shard joined along ``axis`` in rank order (``x`` itself when
    ``group`` is None)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    moved = x.movedim(axis, 0).contiguous()
    out = all_gather(moved, group).view((n * moved.shape[0],)
                                        + moved.shape[1:])
    return out.movedim(0, axis).contiguous()


def shard_of(x: torch.Tensor, n: int, rank: int, axis: int) -> torch.Tensor:
    """Shard ``rank`` of ``n`` of ``x`` along ``axis`` (a view)."""
    size = x.shape[axis] // n
    return x.narrow(axis, rank * size, size)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = (dist.get_world_size(group), dist.get_rank(group), axis)
        return gather_shards(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        n, rank, axis = ctx.args
        return shard_of(g, n, rank, axis).contiguous(), None, None


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return shard_of(x, dist.get_world_size(group), dist.get_rank(group),
                        axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_shards(g, ctx.group, ctx.axis), None, None


def gather_replicated(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """:func:`gather_shards`, differentiable for an output replicated over
    ``group``: the backward is this rank's part of the cotangent."""
    return _GatherReplicated.apply(x, group, axis)


def slice_replicated(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """This rank's part of ``x`` (replicated over ``group``) along
    ``axis``, differentiable: the backward gathers every rank's part of
    the cotangent, the full gradient of ``x``."""
    return _SliceReplicated.apply(x, group, axis)
