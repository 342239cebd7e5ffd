"""One-forward-one-backward (1F1B) pipeline schedule with a hand-built
backward pass.

Port of ``autodist_tpu/parallel/pipeline_1f1b.py``, the JAX package's
index algebra whole (its module docstring gives the schedule): microbatch
``j`` is injected at device 0 at tick ``tj = (j//S)·S·V + j%S``, runs
global stage ``g = v·S + d`` forward at tick ``tj + g`` and backward at
tick ``tj + 2(S·V-1) - g``; the last global stage computes the
per-microbatch loss and its cotangent on the tick its forward completes;
every tick a rank does at most one chunk forward and one chunk backward,
and two ring hops carry the activations forward and the cotangents back
(``collectives.ring_shift`` both ways, every tick, on every rank).  Each
rank keeps a circular stash of ``2·S·V`` saved chunk INPUTS; the backward
recomputes the chunk forward from the saved input and differentiates it
(``torch.autograd.grad``), so a rank holds ``O(S·V)`` activations
whatever ``M``.

Where the JAX package computes every tick on every device and masks the
idle ones with ``where``, a rank here computes only on the ticks where it
holds a microbatch, forward or backward, and sends zeros on the others.
Gradients accumulate in f32 (added, never multiplied by a 0/1 mask) and
come back in the primal dtypes.  The loss, the ``loss_params`` gradients
(on the last stage) and the input's gradient (on stage 0) are replicated
over the pipe group by masked ``all_reduce``\\ s.

Inside a step (``pipe`` in :func:`~autodist_tpu_torch.mesh.
current_manual_axes`) the stage leaves are this rank's ``[V, ...]``
chunks, the rows this data rank's, and the returned stage gradients
this rank's ``[V, ...]``; the step takes the data mean.  Outside one the
leaves are the whole device-major ``[S·V, ...]`` stack (the rank takes
its rows), the stage gradients come back whole (gathered over the pipe
group), and with a ``data`` axis the batch is cut into data shards, each
running its own schedule over its rows, and everything averages over
``data`` (the input's gradient, whose rows are shard-local, is scaled by
``1/D`` and gathered), as the JAX package does.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch
import torch.distributed as dist

from autodist_tpu_torch.const import MESH_AXIS_DATA, MESH_AXIS_PIPE
from autodist_tpu_torch.kernel.synchronization import collectives as coll
# The tick/bubble algebra is pure and shared with the schedule IR, as in
# the JAX package; re-exported here.
from autodist_tpu_torch.kernel.synchronization.schedule_ir import (  # noqa
    bubble_fraction_1f1b, schedule_ticks_1f1b)
from autodist_tpu_torch.mesh import current_manual_axes
from autodist_tpu_torch.parallel.pipeline import (local_stages, stage_slot,
                                                  tree_build, tree_leaves)


def _rows(tree, lo: int, n: int):
    names, leaves = tree_leaves(tree)
    return tree_build(names, [x[lo:lo + n] for x in leaves])


def _microbatch(tree, j: int, m: int):
    names, leaves = tree_leaves(tree)
    return tree_build(names, [x.reshape((m, x.shape[0] // m)
                                        + tuple(x.shape[1:]))[j]
                              for x in leaves])


def one_f_one_b(stage_fn: Callable, loss_fn: Callable, stage_params: Any,
                x: torch.Tensor, targets: Any, mesh, *,
                num_microbatches: int, loss_params: Any = None,
                num_virtual_stages: int = 1,
                axis_name: str = MESH_AXIS_PIPE):
    """Pipelined value-and-grad under the 1F1B schedule.

    ``stage_fn(params_one_stage, x_mb) -> y_mb`` (shape-homogeneous);
    ``loss_fn(y_mb, target_mb) -> scalar``, or with ``loss_params``
    ``loss_fn(loss_params, y_mb, target_mb)`` (the head after the
    pipeline, its gradients accumulated on the last stage); the loss is
    the mean over microbatches.  ``stage_params``: a tree whose leaves
    lead with the ``[S·V]`` stage axis (device-major for V > 1), this
    rank's ``[V]`` inside a step.  ``x``: the batch ``[B, ...]``, ``B %
    num_microbatches == 0``; ``targets``: a tree of tensors with leading
    dim ``B``.  Returns ``(loss, d_stage_params, d_x)``, or with
    ``loss_params`` ``(loss, d_stage_params, d_loss_params, d_x)``."""
    s = int(mesh.shape.get(axis_name, 1)) if mesh is not None else 1
    v = num_virtual_stages
    m = num_microbatches
    b = x.shape[0]
    if v < 1:
        raise ValueError(f"num_virtual_stages must be >= 1, got {v}")
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    for leaf in tree_leaves(targets)[1]:
        if leaf.shape[0] != b:
            raise ValueError(
                f"targets leading dim {leaf.shape[0]} != batch {b}")
    if m < s:
        raise ValueError(f"1F1B needs num_microbatches ({m}) >= stages ({s})")
    names, leaves = tree_leaves(stage_params)
    if s <= 1:
        return _sequential(stage_fn, loss_fn, names, leaves, x, targets, m,
                           loss_params)

    manual = axis_name in current_manual_axes()
    chunks = local_stages(leaves, mesh, axis_name, s, v, False)
    dsize = 1 if manual or axis_name == MESH_AXIS_DATA \
        else int(mesh.shape.get(MESH_AXIS_DATA, 1))
    drank = mesh.axis_rank(MESH_AXIS_DATA) if dsize > 1 else 0
    if dsize > 1:
        if b % (dsize * m):
            raise ValueError(
                f"batch {b} not divisible into {dsize} data shards x {m} "
                "microbatches")
        x = x[drank * (b // dsize):(drank + 1) * (b // dsize)]
        targets = _rows(targets, drank * (b // dsize), b // dsize)
    lp_names, lp_leaves = tree_leaves({} if loss_params is None
                                      else loss_params)
    group = mesh.axis_group(axis_name)
    loss, dparams, dlp, dx = _local_1f1b(
        stage_fn, loss_fn, names, chunks, lp_names, lp_leaves,
        loss_params is not None, x, targets, m, s, v,
        dist.get_rank(group), group)
    if not manual:
        dparams = [coll.gather_shards(g, group, 0) for g in dparams]
    if dsize > 1:
        dgroup = mesh.axis_group(MESH_AXIS_DATA)
        loss = coll.all_reduce(loss, dgroup) / dsize
        dparams = [coll.all_reduce(g, dgroup) / dsize for g in dparams]
        dlp = [coll.all_reduce(g, dgroup) / dsize for g in dlp]
        dx = coll.gather_shards(dx / dsize, dgroup, 0)
    dsp = tree_build(names, [g.to(p.dtype) for g, p in zip(dparams, leaves)])
    dx = dx.to(x.dtype)
    if loss_params is None:
        return loss, dsp, dx
    return loss, dsp, tree_build(lp_names, [
        g.to(p.dtype) for g, p in zip(dlp, lp_leaves)]), dx


def _sequential(stage_fn, loss_fn, names, leaves, x, targets, m,
                loss_params):
    """``S == 1``: the plain loop over the stage dimension, differentiated
    by autograd (nothing to schedule)."""
    sp = [p.detach().requires_grad_() for p in leaves]
    lp_names, lp_leaves = tree_leaves({} if loss_params is None
                                      else loss_params)
    lp = [p.detach().requires_grad_() for p in lp_leaves]
    xx = x.detach().requires_grad_()
    with torch.enable_grad():
        h = xx
        for i in range(sp[0].shape[0]):
            h = stage_fn(tree_build(names, [p[i] for p in sp]), h)
        fn = loss_fn if loss_params is None \
            else functools.partial(loss_fn, tree_build(lp_names, lp))
        loss = torch.stack([fn(_microbatch(h, j, m),
                               _microbatch(targets, j, m))
                            for j in range(m)]).mean()
        grads = torch.autograd.grad(loss, [xx] + sp + lp, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, [xx] + sp + lp)]
    dx, dsp = grads[0], tree_build(names, grads[1:1 + len(sp)])
    if loss_params is None:
        return loss.detach(), dsp, dx
    return loss.detach(), dsp, tree_build(lp_names, grads[1 + len(sp):]), dx


def _local_1f1b(stage_fn, loss_fn, names, chunks, lp_names, lp_leaves,
                has_lp, x, targets, m, s, v, d, group):
    """One rank's 1F1B tick loop over ``x``'s rows: ``(loss, [V, ...] f32
    stage gradients, loss_params gradients, input gradient)``, the loss
    and the loss_params and input gradients replicated over the pipe
    group."""
    period = s * v
    k = 2 * s * v                                     # stash slots
    mb = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
    chunk_at = [tree_build(names, [p[c] for p in chunks]) for c in range(v)]
    dparams = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in chunks]
    dlp = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in lp_leaves]
    dx_bank = torch.zeros(mb.shape, dtype=torch.float32, device=x.device)
    loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    stash = [None] * k
    zero_a = torch.zeros_like(mb[0])
    zero_g = torch.zeros(mb[0].shape, dtype=torch.float32, device=x.device)
    a_in, g_in = zero_a, zero_g
    for t in range(schedule_ticks_1f1b(s, m, v)):
        # ---- forward: the chunk this rank forwards now -----------------
        vf, jf, tjf = stage_slot(t, d, s, v)
        y, dy_loss = zero_a, None
        if tjf >= 0 and jf < m:
            x_in = mb[jf] if d == 0 and vf == 0 else a_in
            with torch.no_grad():
                y = stage_fn(chunk_at[vf], x_in)
            stash[t % k] = x_in          # the chunk input, for recompute
            if d == s - 1 and vf == v - 1:
                # the last global stage: the microbatch's loss and its
                # cotangent, entering the backward stream this tick
                tgt = _microbatch(targets, jf, m)
                yy = y.detach().requires_grad_()
                lps = [p.detach().requires_grad_() for p in lp_leaves]
                with torch.enable_grad():
                    loss_j = loss_fn(tree_build(lp_names, lps), yy, tgt) \
                        if has_lp else loss_fn(yy, tgt)
                    got = torch.autograd.grad(
                        loss_j, [yy] + lps,
                        torch.tensor(1.0 / m, dtype=loss_j.dtype,
                                     device=loss_j.device),
                        allow_unused=True)
                dy_loss = got[0]
                for i, g in enumerate(got[1:]):
                    if g is not None:
                        dlp[i] += g.float()
                loss_acc = loss_acc + loss_j.detach().float() / m
        # ---- backward: invert tb = tj + 2(SV-1) - g for this rank -----
        u = t + d - 2 * (s * v - 1)
        vb = (-((u % period) // s)) % v
        gb = vb * s + d
        tjb = u + vb * s
        jb = (tjb // period) * s + tjb % s
        dxin = zero_g
        if tjb >= 0 and jb < m:
            fresh = d == s - 1 and vb == v - 1
            if fresh and dy_loss is None:
                raise AssertionError(f"1F1B tick {t}: the last stage's "
                                     f"cotangent of microbatch {jb} is "
                                     f"missing")
            ct = dy_loss if fresh else g_in
            xs = stash[(tjb + gb) % k].detach().requires_grad_()
            ps = [p.detach().requires_grad_() for p in
                  tree_leaves(chunk_at[vb])[1]]
            with torch.enable_grad():
                y2 = stage_fn(tree_build(names, ps), xs)
                got = torch.autograd.grad(y2, [xs] + ps, ct.to(y2.dtype),
                                          allow_unused=True)
            for i, g in enumerate(got[1:]):
                if g is not None:
                    dparams[i][vb] += g.float()
            if got[0] is not None:
                dxin = got[0].float()
            if d == 0 and vb == 0:
                dx_bank[jb] = dxin      # the injected microbatch's
        a_in = coll.ring_shift(y, group, 1).view(y.shape)
        g_in = coll.ring_shift(dxin, group, -1).view(dxin.shape)
    # the loss and loss-side grads live on the last stage, dx on stage 0
    if d != s - 1:
        loss_acc = torch.zeros_like(loss_acc)
        dlp = [torch.zeros_like(g) for g in dlp]
    if d != 0:
        dx_bank.zero_()
    loss = coll.all_reduce(loss_acc, group)
    dlp = [coll.all_reduce(g, group) for g in dlp]
    dx = coll.all_reduce(dx_bank, group).reshape(
        (x.shape[0],) + tuple(x.shape[1:]))
    return loss, dparams, dlp, dx
