"""Ring attention: sequence-parallel exact attention over the ``seq`` axis.

Port of the JAX package's ``parallel/ring_attention.py`` (blockwise ring
attention, Liu et al. 2023).  Each rank holds one chunk of every
sequence; K/V blocks travel around the seq group's ring
(:func:`~autodist_tpu_torch.kernel.synchronization.collectives.ppermute`,
``i -> i + 1``) while the rank's queries accumulate the output.  The
backward sends dK and dV back around the ring (the reverse shift), as JAX
transposes ``ppermute``.

Two inner computations:

* ``"dense"`` — the online softmax in plain torch (running max and sum,
  masked logits at -1e30), the JAX module's ``_ring_attention_local``;
* ``"flash"`` — the flash kernels K1–K3 on each block
  (:func:`~autodist_tpu_torch.ops.flash_attention.flash_attention_with_lse`):
  step 0 is the diagonal block, causal; each later step runs K1
  non-causal on the block shifted in, and the partial outputs merge in
  log space (:func:`merge_partial`).  A block from a future chunk has its
  lse masked to -1e30 before the merge, an exact no-op that keeps the
  ring uniform.  In the backward K2/K3 receive ``Δ − dlse``.

``"auto"`` takes flash for CUDA tensors and dense on the CPU, the JAX
package's backend rule, per call.

Layout: q/k/v are ``[batch, seq, heads, head_dim]``.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from autodist_tpu_torch.const import MESH_AXIS_SEQ
from autodist_tpu_torch.kernel.synchronization.collectives import ppermute
from autodist_tpu_torch.mesh import current_seq_chunk

_NEG_INF = -1e30  # finite "minus infinity": keeps exp()/max() NaN-free


def _check_inner(inner: str) -> str:
    if inner not in ("auto", "dense", "flash"):
        raise ValueError(f"inner must be dense|flash|auto, got {inner!r}")
    return inner


def _check_axis(axis_name: str) -> None:
    if axis_name != MESH_AXIS_SEQ:
        raise ValueError(f"sequence-parallel attention runs over the "
                         f"{MESH_AXIS_SEQ!r} axis, got {axis_name!r}")


def uses_flash(inner: str, q: torch.Tensor) -> bool:
    """Does ``inner`` take the flash kernels for ``q``'s device?"""
    return inner == "flash" or (inner == "auto" and q.device.type == "cuda")


def full_attention(inner: str, q, k, v, causal: bool) -> torch.Tensor:
    """``inner``'s attention over whole sequences (no chunking): the flash
    kernels or dense softmax attention."""
    if uses_flash(inner, q):
        from autodist_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal)
    from autodist_tpu_torch.models.transformer import dense_attention

    return dense_attention(q, k, v, causal)


def _ring_dense(q, k, v, causal: bool, chunk) -> torch.Tensor:
    """The online-softmax ring on one rank: q/k/v are its chunks."""
    size, me = chunk.size, chunk.rank
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    q32 = q.float()
    q_pos = me * t_q + torch.arange(t_q, device=q.device)
    o = q.new_zeros((b, h, t_q, d), dtype=torch.float32)
    l = q.new_zeros((b, h, t_q), dtype=torch.float32)
    m = q.new_full((b, h, t_q), _NEG_INF, dtype=torch.float32)
    k_blk, v_blk = k, v
    for step in range(size):
        j = (me - step) % size        # the chunk this block came from
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float()) * scale
        if causal:
            k_pos = j * t_k + torch.arange(t_k, device=q.device)
            allowed = k_pos[None, :] <= q_pos[:, None]
            logits = torch.where(allowed[None, None], logits,
                                 logits.new_tensor(_NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               v_blk.float())
        m = m_new
        if step < size - 1:           # no shift nothing consumes
            k_blk = ppermute(k_blk, chunk.group)
            v_blk = ppermute(v_blk, chunk.group)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def merge_partial(acc, lse_acc, o_b, lse_b):
    """Merge two partial attention outputs in log space: ``lse' =
    logaddexp(lse_a, lse_b)``, ``o' = o_a·exp(lse_a − lse') + o_b·exp(lse_b
    − lse')``.  ``acc``/``o_b`` ``[B, T, H, D]`` (f32 accumulator),
    ``lse_acc``/``lse_b`` ``[B, T, H]``."""
    lse_new = torch.logaddexp(lse_acc, lse_b)
    acc = acc * torch.exp(lse_acc - lse_new)[..., None] \
        + o_b.float() * torch.exp(lse_b - lse_new)[..., None]
    return acc, lse_new


def _ring_flash(q, k, v, causal: bool, chunk) -> torch.Tensor:
    """The flash ring on one rank: K1 on the diagonal block (causal), then
    on each block shifted in (full), merged in log space."""
    from autodist_tpu_torch.ops.flash_attention import \
        flash_attention_with_lse

    size, me = chunk.size, chunk.rank
    o0, lse0 = flash_attention_with_lse(q, k, v, causal)
    acc, lse_acc = o0.float(), lse0.transpose(1, 2)       # [B, Tq, H]
    k_blk, v_blk = k, v
    for step in range(1, size):
        k_blk = ppermute(k_blk, chunk.group)
        v_blk = ppermute(v_blk, chunk.group)
        j = (me - step) % size                            # block owner
        o_b, lse_b = flash_attention_with_lse(q, k_blk, v_blk, False)
        lse_b = lse_b.transpose(1, 2)
        if causal and j > me:
            # a future chunk: masked out of the merge
            lse_b = torch.full_like(lse_b, _NEG_INF)
        acc, lse_acc = merge_partial(acc, lse_acc, o_b, lse_b)
    return acc.to(q.dtype)


def make_ring_attention(mesh, axis_name: str = MESH_AXIS_SEQ,
                        inner: str = "auto") -> Callable:
    """An ``attn_fn(q, k, v, causal)`` drop-in for
    :func:`~autodist_tpu_torch.models.transformer.dense_attention`,
    sequence-parallel over ``axis_name`` of ``mesh``.

    Contract: inside a step on a seq axis wider than 1
    (:func:`~autodist_tpu_torch.mesh.seq_chunk`), q/k/v are THIS RANK's
    chunk ``[B, T/s, H, D]`` of the sequence (chunk ``r`` holds positions
    ``r·T/s .. (r+1)·T/s``) and the result is this rank's chunk of the
    output; every rank of the seq group calls it together (the JAX
    function takes the global tensors inside ``jit`` and lets
    ``shard_map`` cut them).  Outside such a step (an evaluation on whole
    sequences, a mesh without the axis) it is ``inner``'s attention over
    the whole sequence."""
    _check_axis(axis_name)
    _check_inner(inner)

    def attn_fn(q, k, v, causal: bool):
        chunk = current_seq_chunk()
        if chunk is None or chunk.size <= 1:
            return full_attention(inner, q, k, v, causal)
        if uses_flash(inner, q):
            return _ring_flash(q, k, v, bool(causal), chunk)
        return _ring_dense(q, k, v, bool(causal), chunk)

    attn_fn.sequence_parallel = True
    return attn_fn
