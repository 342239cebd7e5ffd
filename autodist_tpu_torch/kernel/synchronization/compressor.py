"""Gradient compressors around the data axis's reduction.

Port of the JAX package's ``kernel/synchronization/compressor.py:28-84,
187-287`` for what the explicit bucketed step runs: the identity
(:class:`NoneCompressor`) and the quantized wire (:class:`Int8Compressor`,
:class:`Fp8Compressor`, on :class:`QuantizedRingCompressor`).  A
compressor is a set of functions over a ``torch.distributed`` group of
``n`` ranks; its per-rank state (the error-feedback residual) is carried
by the caller in the step's sync state.

The JAX package's cast compressors (``HorovodCompressor``,
``HorovodCompressorEF``) and ``PowerSGDCompressor`` are registered names
here: :func:`get_compressor` refuses them, naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from autodist_tpu_torch.const import not_ported
from autodist_tpu_torch.kernel.synchronization import collectives as coll
from autodist_tpu_torch.kernel.synchronization import quant_ring

#: the ROADMAP item of the compressors still to port
UNPORTED_ITEM = "P6 — cast and low-rank compressors"


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


_REGISTRY: Dict[str, Optional[type]] = {
    "NoneCompressor": NoneCompressor,
    "HorovodCompressor": None,
    "HorovodCompressorEF": None,
    "PowerSGDCompressor": None,
    "Int8Compressor": Int8Compressor,
    "Fp8Compressor": Fp8Compressor,
}


def get_compressor(name: str) -> Compressor:
    """The compressor registered as ``name`` (``""`` is
    ``NoneCompressor``)."""
    name = name or "NoneCompressor"
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; "
                         f"available: {sorted(_REGISTRY)}")
    cls = _REGISTRY[name]
    if cls is None:
        raise not_ported(f"compressor {name!r}", UNPORTED_ITEM)
    return cls()
