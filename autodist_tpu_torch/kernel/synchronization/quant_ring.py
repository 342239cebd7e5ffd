"""Quantized ring collectives: int8/fp8 wire, per-chunk scales.

Port of the JAX package's ``kernel/synchronization/quant_ring.py:44-400``
(EQuARX, arXiv:2506.17615).  Three rules, as there:

1. **A per-chunk scale grid, computed in the legs.**  A flat vector is
   quantized in :data:`QUANT_BLOCK_ELEMS`-element blocks, each with its
   own f32 scale (``ops/quant_scale.chunk_scale`` of the block's finite
   amax); the scales travel with the payload.  Every tier (the ring hops,
   the one-shot ``all_to_all`` reduce-scatter, the gathers) calls
   ``ops/quant_scale.quantize_blocks``, which owns the wire format; this
   module re-exports it with the format's names.
2. **Dequantize, accumulate in f32, requantize per hop.**  The partial
   sum never travels wider than one byte per element plus scales.  The
   stage-1 quantization error comes back vector-shaped, for the caller to
   carry as error feedback; stage 2 (the re-quantized all-gather of the
   reduced value) is uncompensated.
3. **Saturation counted where it happens**: each quantize event counts
   the elements it clipped to the rail or received non-finite; the
   numerics guard rolls the counts up.

The collectives run over a ``torch.distributed`` group of ``n`` ranks
(:mod:`.collectives`; ``ppermute`` is :func:`~.collectives.ring_shift`).
With ``fused=True`` the reduce-scatter's hop boundaries run the CUDA
kernels of ``ops/fused_kernels.py`` on CUDA tensors: K6 quantizes the
first send, K7 dequantizes, accumulates and requantizes at each of the
``n - 2`` middle hops, K8 dequantizes and accumulates the last receive.
The unfused ring (``fused=False``) is the JAX package's, kept as it is;
both put the same bits on the wire.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from autodist_tpu_torch.kernel.synchronization import collectives as coll
from autodist_tpu_torch.telemetry.timeline import sync_span
from autodist_tpu_torch.kernel.synchronization.bucketing import (
    MODE_REDUCE_SCATTER, OVERLAP_FULL, OVERLAP_RING)
from autodist_tpu_torch.ops import fused_kernels as fk
# the wire's data format: one definition, in the ops layer
from autodist_tpu_torch.ops.quant_scale import (  # noqa: F401
    QUANT_BLOCK_ELEMS, WIRE_FP8_E4M3, WIRE_INT8, WireFormat, dequantize_add,
    dequantize_blocks, quantization_error, quantize_blocks, scale_count,
    wire_dtype)

#: compressors whose buckets go over the quantized wire
WIRE_FORMATS = {
    "Int8Compressor": WIRE_INT8,
    "Fp8Compressor": WIRE_FP8_E4M3,
}


def wire_format_of(compressor: str) -> Optional[WireFormat]:
    """The wire format ``compressor`` puts on the ring, or None."""
    return WIRE_FORMATS.get(compressor or "")


def is_quant_ring_compressor(compressor: str) -> bool:
    return (compressor or "") in WIRE_FORMATS


def ring_applies(mode: str, nbytes: int, d: int, threshold: int) -> bool:
    """Does a quantized bucket ring-decompose?  Only under an explicit
    ``overlap="ring"`` or ``"full"`` (per-hop requantization changes the
    wire numerics against the one-shot collective, and ``auto`` never
    changes numerics), over more than one rank, at or above the byte
    threshold linear buckets use."""
    return (mode in (OVERLAP_RING, OVERLAP_FULL) and d > 1
            and int(nbytes) >= int(threshold))


def scale_nbytes(length: int) -> int:
    """Bytes of f32 scales beside ``length`` quantized elements."""
    return 4 * scale_count(length)


def wire_nbytes(length: int, fmt: WireFormat) -> int:
    """Wire bytes of one quantized transfer of ``length`` elements: the
    one-byte payload plus the scales."""
    return int(length) * fmt.itemsize + scale_nbytes(length)


# -- the quantized ring ------------------------------------------------------
def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=like.device)


def quantized_ring_reduce_scatter(vec: torch.Tensor, group, n: int,
                                  fmt: WireFormat, fused: bool = False):
    """Sum-reduce-scatter of flat ``vec`` (length divisible by ``n``) as
    ``n - 1`` quantized ring hops: each hop quantizes the f32 partial with
    fresh scales, sends payload and scales to the next rank, dequantizes
    on arrival and adds the receiver's own chunk, so rank ``r`` ends with
    the f32 ``sum over ranks of chunk r``.  Returns ``(shard_sum, err,
    sat)``: ``err`` is this rank's stage-1 quantization error,
    vector-shaped, each hop's at the chunk it was quantizing.
    ``fused=True`` runs each hop boundary through K6–K8."""
    if n <= 1:
        return vec, torch.zeros_like(vec), _zero(vec)
    chunks = vec.reshape(n, -1)
    idx = dist.get_rank(group)
    err = torch.zeros_like(chunks)
    if fused:
        # hop s's receive side and hop s+1's send side are one boundary;
        # the first send and the last receive are the half-boundaries
        with sync_span("quant_ring_fused/leg1"):
            q, scales, err[(idx - 1) % n], sat = fk.fused_quantize(
                chunks[(idx - 1) % n], fmt)
        for s in range(1, n):
            with sync_span(f"quant_ring_fused/leg{s}"):
                q = coll.ring_shift(q, group)
                scales = coll.ring_shift(scales, group)
                chunk = chunks[(idx - 1 - s) % n]
                if s < n - 1:
                    q, scales, err_h, s_cnt = fk.fused_hop_accumulate(
                        q, scales, chunk, fmt)
                    err[(idx - 1 - s) % n] = err_h
                    sat = sat + s_cnt
                else:
                    acc = fk.fused_dequant_add(q, scales, chunk, fmt)
        return acc, err.reshape(vec.shape), sat
    acc = chunks[(idx - 1) % n]
    sat = _zero(vec)
    for s in range(1, n):
        with sync_span(f"quant_ring_reduce_scatter/leg{s}"):
            q, scales, s_cnt = quantize_blocks(acc, fmt)
            # before hop s this rank's partial is destined for chunk
            # idx - s
            err[(idx - s) % n] = quantization_error(acc, q, scales)
            sat = sat + s_cnt
            q = coll.ring_shift(q, group)
            scales = coll.ring_shift(scales, group)
            acc = dequantize_add(q, scales, chunks[(idx - 1 - s) % n])
    return acc, err.reshape(vec.shape), sat


def quantized_ring_all_gather(shard: torch.Tensor, group, n: int,
                              fmt: WireFormat):
    """All-gather of every rank's f32 ``shard`` over the quantized ring:
    the shard is quantized once (stage 2, uncompensated), payload and
    scales circulate ``n - 1`` hops, and every rank materializes the
    DEQUANTIZED value of every shard, its own included, so replicated
    consumers stay bit-identical across ranks.  ``(gathered, sat)``."""
    if n <= 1:
        return shard, _zero(shard)
    idx = dist.get_rank(group)
    q, scales, sat = quantize_blocks(shard, fmt)
    out = shard.new_empty((n, shard.numel()), dtype=torch.float32)
    out[idx] = dequantize_blocks(q, scales)
    for s in range(1, n):
        with sync_span(f"quant_ring_all_gather/leg{s}"):
            q = coll.ring_shift(q, group)
            scales = coll.ring_shift(scales, group)
            out[(idx - s) % n] = dequantize_blocks(q, scales)
    return out.reshape(-1), sat


# -- the one-shot lowerings --------------------------------------------------
def quantized_all_to_all_reduce_scatter(vec: torch.Tensor, group, n: int,
                                        fmt: WireFormat):
    """One-shot quantized reduce-scatter: each of the ``n`` chunks is
    quantized on its own grid, payloads and scales go out in one
    ``all_to_all`` each, and the received contributions are dequantized
    with their senders' scales and summed in f32.  ``(shard_sum, err,
    sat)`` like the ring (``err`` the single quantize event's)."""
    if n <= 1:
        return vec, torch.zeros_like(vec), _zero(vec)
    chunks = vec.reshape(n, -1)
    with sync_span("quant_all_to_all_reduce_scatter"):
        parts = [quantize_blocks(c, fmt) for c in chunks]
        q = torch.stack([p[0] for p in parts])
        scales = torch.stack([p[1] for p in parts])
        err = torch.cat([quantization_error(c, p[0], p[1])
                         for c, p in zip(chunks, parts)])
        recv_q = coll.all_to_all(q.reshape(-1), group).reshape(q.shape)
        recv_s = coll.all_to_all(scales.reshape(-1),
                                 group).reshape(scales.shape)
        owned = torch.stack([dequantize_blocks(recv_q[j], recv_s[j])
                             for j in range(n)]).sum(dim=0)
    return owned, err, torch.stack([p[2] for p in parts]).sum()


def quantized_all_gather(shard: torch.Tensor, group, n: int,
                         fmt: WireFormat):
    """One-shot quantized all-gather (stage 2): quantize the owned shard,
    ``all_gather`` payload and scales, dequantize every shard, the local
    one included.  ``(gathered, sat)``."""
    if n <= 1:
        return shard, _zero(shard)
    with sync_span("quant_all_gather"):
        q, scales, sat = quantize_blocks(shard, fmt)
        gq = coll.all_gather(q, group).reshape(n, -1)
        gs = coll.all_gather(scales, group).reshape(n, -1)
        full = torch.cat([dequantize_blocks(gq[j], gs[j])
                          for j in range(n)])
    return full, sat


# -- the bucket-level entry point --------------------------------------------
def quant_bucket_reduce(vec: torch.Tensor, state: Optional[torch.Tensor],
                        group, n: int, fmt: WireFormat, *, mode: str,
                        alg: str, fused: bool = False):
    """Reduce one flat bucket through the quantized wire.

    ``mode`` is the bucket's sync mode (``all_reduce`` returns the full
    mean vector, ``reduce_scatter`` this rank's ``1/n`` mean shard);
    ``alg`` the resolved lowering (``"ring"`` the per-hop requantizing
    ring, anything else the one-shot ``all_to_all``).  Error feedback:
    ``state`` (this rank's vector-shaped stage-1 residual) is added before
    quantization and the new residual returned; the all-gather leg is
    uncompensated.  ``fused`` runs the ring's hop boundaries through
    K6–K8.  Returns ``(reduced, new_state, sat)``."""
    orig_dtype = vec.dtype
    corrected = vec.float()
    if state is not None:
        corrected = corrected + state.float()
    if n <= 1:
        new_state = torch.zeros_like(vec) if state is not None else None
        return corrected.to(orig_dtype), new_state, _zero(vec)
    if alg == "ring":
        shard_sum, err, sat = quantized_ring_reduce_scatter(
            corrected, group, n, fmt, fused=fused)
    else:
        shard_sum, err, sat = quantized_all_to_all_reduce_scatter(
            corrected, group, n, fmt)
    new_state = err.to(orig_dtype) if state is not None else None
    mean_shard = shard_sum / n
    if mode == MODE_REDUCE_SCATTER:
        return mean_shard.to(orig_dtype), new_state, sat
    if alg == "ring":
        full, sat2 = quantized_ring_all_gather(mean_shard, group, n, fmt)
    else:
        full, sat2 = quantized_all_gather(mean_shard, group, n, fmt)
    return full.to(orig_dtype), new_state, sat + sat2
