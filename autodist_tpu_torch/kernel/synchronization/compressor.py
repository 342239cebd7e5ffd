"""Gradient compressors around the data axis's reduction.

Port of the JAX package's ``kernel/synchronization/compressor.py``: the
identity (:class:`NoneCompressor`), the bf16 cast with and without error
feedback (:class:`HorovodCompressor`, :class:`HorovodCompressorEF`), the
rank-r low-rank :class:`PowerSGDCompressor` and the quantized wire
(:class:`Int8Compressor`, :class:`Fp8Compressor`, on
:class:`QuantizedRingCompressor`).  A compressor is a set of functions
over a ``torch.distributed`` group of ``n`` ranks; its per-rank state
(the error-feedback residual, PowerSGD's basis) is carried by the caller
in the step's sync state.

At ``n == 1`` every compressor but the quantized wire returns the
gradient and its state unchanged: the JAX package runs a compressor at
data size 1 on its GSPMD step, where nothing is compressed
(``graph_transformer.py:244-247``), so a one-rank session equals the
uncompressed one bit for bit.

One divergence: PowerSGD's initial basis.  The JAX package draws it
from its threefry generator keyed ``n*31 + m``, which torch cannot
reproduce; the port draws it from a ``torch.Generator`` seeded with the
same number.  Both are Gaussian bases; a parity test carries the JAX
basis across through ``convert.sync_state_from_jax``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from autodist_tpu_torch.kernel.synchronization import collectives as coll
from autodist_tpu_torch.kernel.synchronization import quant_ring


class Compressor:
    """Base: reduce (and, for flat-composable compressors,
    reduce-scatter) over the data group, with optional state.

    ``bucketable`` marks compressors whose wire format composes with flat
    gradient buckets.  Quantized-wire compressors also implement
    :meth:`bucket_reduce` / :meth:`bucket_reduce_scatter`, which take the
    resolved algorithm and return the saturation count."""

    name = "Compressor"
    bucketable = True

    def init_state(self, value: torch.Tensor) -> Any:
        """This rank's sync state for one variable or bucket, or None."""
        return None

    def reduce(self, grad, state, group, n: int) -> Tuple[Any, Any]:
        """``(the mean of grad over the group, new state)``."""
        raise NotImplementedError

    def reduce_scatter(self, vec, state, group, n: int) -> Tuple[Any, Any]:
        """``(this rank's 1/n slice of the mean of flat vec, new
        state)``."""
        raise NotImplementedError(
            f"{self.name} does not support reduce-scatter (ZeRO-1) mode")


class NoneCompressor(Compressor):
    """Identity compression: the plain mean."""

    name = "NoneCompressor"

    def reduce(self, grad, state, group, n):
        if n <= 1:
            return grad, state
        return coll.all_reduce(grad, group) / n, state

    def reduce_scatter(self, vec, state, group, n):
        if n <= 1:
            return vec, state
        return coll.reduce_scatter(vec, group) / n, state


class HorovodCompressor(Compressor):
    """Cast-down compression: the mean is taken in bfloat16 on the wire
    (the sum and the division by ``n``, as ``lax.pmean`` of a bf16 value
    does) and cast back."""

    name = "HorovodCompressor"
    wire = torch.bfloat16

    def _corrected(self, grad, state):
        return grad, state

    def reduce(self, grad, state, group, n):
        if n <= 1:
            return grad, state
        corrected, new_state = self._corrected(grad, state)
        summed = coll.all_reduce(corrected.to(self.wire), group)
        return (summed / n).to(grad.dtype), new_state

    def reduce_scatter(self, vec, state, group, n):
        if n <= 1:
            return vec, state
        corrected, new_state = self._corrected(vec, state)
        shard = coll.reduce_scatter(corrected.to(self.wire), group)
        return (shard / n).to(vec.dtype), new_state


class HorovodCompressorEF(HorovodCompressor):
    """Error-feedback cast compression: each round's cast error is added
    back before the next cast (Karimireddy et al., 2019).  The residual is
    local and computed before the scatter, so it is full-bucket sized
    under ZeRO-1 too."""

    name = "HorovodCompressorEF"

    def init_state(self, value):
        return torch.zeros_like(value)

    def _corrected(self, grad, state):
        corrected = grad + state
        compressed = corrected.to(self.wire)
        return compressed, corrected - compressed.to(grad.dtype)


class PowerSGDCompressor(Compressor):
    """Rank-r PowerSGD (Vogels et al., 2019) on 2-D gradients; any other
    gradient falls back to the mean.  State ``{"q": [m, r] basis,
    "residual": error feedback}``: ``P = M Q`` is averaged, orthonormalized
    (QR), ``Q = Mᵀ P̂`` is averaged, and ``P̂ Qᵀ`` is the applied
    gradient.  Not bucketable: the factors need the 2-D gradient, so its
    variables keep a per-variable collective."""

    name = "PowerSGDCompressor"
    bucketable = False

    def __init__(self, rank: int = 1):
        self.rank = rank

    def init_state(self, value):
        shape = tuple(value.shape)
        if len(shape) != 2:
            return None
        n, m = shape
        gen = torch.Generator(device="cpu").manual_seed(n * 31 + m)
        q = torch.randn((m, self.rank), generator=gen, dtype=torch.float32)
        return {"q": q.to(device=value.device, dtype=value.dtype),
                "residual": torch.zeros_like(value)}

    def reduce(self, grad, state, group, n):
        if n <= 1:
            return grad, state
        if state is None or grad.dim() != 2:
            return coll.all_reduce(grad, group) / n, state
        corrected = grad + state["residual"]
        p = coll.all_reduce(corrected @ state["q"], group) / n
        p_hat, _ = torch.linalg.qr(p)
        new_q = coll.all_reduce(corrected.T @ p_hat, group) / n
        approx = p_hat @ new_q.T
        return approx, {"q": new_q, "residual": corrected - approx}


class QuantizedRingCompressor(Compressor):
    """Quantized-wire reduction with error feedback on the per-chunk scale
    grid (``quant_ring``): the one-byte payload and its scales are what
    cross the wire.  Stage-1 error is this rank's sync state; stage 2 is
    uncompensated.  Subclasses pin the wire format."""

    name = "QuantizedRingCompressor"
    wire = quant_ring.WIRE_INT8

    def init_state(self, value):
        return torch.zeros_like(value)

    def reduce(self, grad, state, group, n):
        flat = (grad + state).float().reshape(-1)
        pad = (-flat.numel()) % max(n, 1)
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        mean, new_state, _ = quant_ring.quant_bucket_reduce(
            flat, torch.zeros_like(flat), group, n, self.wire,
            mode="all_reduce", alg="fused")
        size = grad.numel()
        return (mean[:size].reshape(grad.shape).to(grad.dtype),
                new_state[:size].reshape(grad.shape).to(grad.dtype))

    def reduce_scatter(self, vec, state, group, n):
        shard, new_state, _ = self.bucket_reduce_scatter(vec, state, group,
                                                         n, alg="fused")
        return shard, new_state

    def bucket_reduce(self, vec, state, group, n, alg="fused"):
        """The full mean of flat ``vec`` under ``alg``: ``(mean,
        new_state, sat)``; a ring's hop boundaries run K6–K8."""
        return quant_ring.quant_bucket_reduce(
            vec, state, group, n, self.wire, mode="all_reduce", alg=alg,
            fused=True)

    def bucket_reduce_scatter(self, vec, state, group, n, alg="fused"):
        """This rank's ``1/n`` mean shard (the ZeRO-1 leg, the update runs
        on the f32-dequantized shard): ``(shard, new_state, sat)``; a
        ring's hop boundaries run K6–K8."""
        return quant_ring.quant_bucket_reduce(
            vec, state, group, n, self.wire, mode="reduce_scatter",
            alg=alg, fused=True)


class Int8Compressor(QuantizedRingCompressor):
    """Int8 wire (the ±127 grid), per-chunk scales."""

    name = "Int8Compressor"
    wire = quant_ring.WIRE_INT8


class Fp8Compressor(QuantizedRingCompressor):
    """Fp8 e4m3 wire (``torch.float8_e4m3fn``, max finite 448)."""

    name = "Fp8Compressor"
    wire = quant_ring.WIRE_FP8_E4M3


_REGISTRY: Dict[str, type] = {
    c.name: c for c in (NoneCompressor, HorovodCompressor,
                        HorovodCompressorEF, PowerSGDCompressor,
                        Int8Compressor, Fp8Compressor)
}


def get_compressor(name: str) -> Compressor:
    """The compressor registered as ``name`` (``""`` is
    ``NoneCompressor``)."""
    name = name or "NoneCompressor"
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; "
                         f"available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
