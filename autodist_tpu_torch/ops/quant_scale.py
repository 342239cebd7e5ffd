"""The symmetric-quantization scale rules, in PyTorch.

The port's own copy of ``autodist_tpu/ops/quant_scale.py``.  Two zero-amax
conventions exist on purpose and are kept apart:

* :func:`chunk_scale` (the collective wire): ``max(amax / qmax,
  SCALE_FLOOR)`` over a block's FINITE amax, so an all-zero gradient block
  quantizes to zeros and back exactly;
* :func:`channel_scale` (stored weights): ``amax / qmax`` with all-zero
  channels pinned at the identity scale 1.0 — the stored scale is
  long-lived model state and an identity scale is the honest "nothing
  here" marker.

:func:`quantize_values` clips the scaled values to the rail and casts;
:func:`saturation_count` counts what one quantize event clipped or
received non-finite.  One copy serves the weight-only int8 path and the
collective wire's block rule below.

The wire's data format lives here too (the JAX package keeps it in
``kernel/synchronization/quant_ring.py:44-206``): the wire formats
(:data:`WIRE_INT8`, :data:`WIRE_FP8_E4M3`), :func:`quantize_blocks` on
the :data:`QUANT_BLOCK_ELEMS`-element scale grid, its inverse and the
one-rounding :func:`dequantize_add` / :func:`quantization_error`.  The
quantized ring, its compressors and the plain versions of K6–K8 all
build on them.

``chunk_scale`` divides by the constant ``qmax`` as the JAX package's
compiled programs do: XLA turns ``amax / qmax`` into ``amax * (1 /
qmax)`` with the reciprocal rounded to f32, jitted and inside the Pallas
kernel alike.  The port keeps that form so its payloads, scales and
saturation counts equal the JAX runs bit for bit.  It also keeps a
block's amax element on the rail: with a correctly rounded ``amax /
448`` about one fp8 block in twelve would put it one ulp above 448 and
count it as saturated.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: positive floor keeping all-zero-block scales finite and exact.
SCALE_FLOOR = 1e-30
#: one f32 scale per this many elements on the collective wire
QUANT_BLOCK_ELEMS = 256


@dataclass(frozen=True)
class WireFormat:
    """One quantized wire format."""

    name: str       # the wire dtype's name
    qmax: float     # largest finite wire magnitude the grid targets
    itemsize: int = 1


WIRE_INT8 = WireFormat(name="int8", qmax=127.0)
#: fp8 e4m3 (``torch.float8_e4m3fn``): max finite 448, no inf encoding.
WIRE_FP8_E4M3 = WireFormat(name="float8_e4m3fn", qmax=448.0)


def wire_dtype(fmt: WireFormat) -> torch.dtype:
    return torch.int8 if fmt.name == "int8" else torch.float8_e4m3fn


def scale_count(length: int) -> int:
    """Scales covering ``length`` elements."""
    return -(-int(length) // QUANT_BLOCK_ELEMS) if length else 0


def reciprocal(qmax: float) -> float:
    """``1 / qmax`` rounded to f32 (the multiplier :func:`chunk_scale`
    and the CUDA kernels use)."""
    return float(np.float32(1.0) / np.float32(qmax))


def chunk_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """Per-chunk collective-wire scale: ``max(amax * (1 / qmax),
    SCALE_FLOOR)`` in f32.  ``amax`` is the block's FINITE absolute max
    (non-finite entries land in the saturation counter instead of
    flattening the grid)."""
    return torch.clamp_min(amax * reciprocal(qmax), SCALE_FLOOR)


def channel_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """Per-output-channel stored-weight scale: ``amax / qmax`` with
    all-zero channels pinned at 1.0."""
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def quantize_values(y: torch.Tensor, qmax: float, wire_dtype, *,
                    rounded: bool) -> torch.Tensor:
    """Clip ``y`` (already divided by its scale) to ``±qmax`` and cast.
    ``rounded=True`` rounds half to even before the clip (the int8 rule,
    as ``jnp.round``) and sends NaN to 0, as XLA's float-to-int cast does
    (PyTorch's leaves it undefined); ±Inf clips to the rail.  The float
    wire (fp8) rounds in its own cast and keeps NaN."""
    if rounded:
        y = torch.round(y)
        y = torch.where(torch.isnan(y), torch.zeros_like(y), y)
    return torch.clamp(y, -qmax, qmax).to(wire_dtype)


def saturation_count(y: torch.Tensor, finite: torch.Tensor, qmax: float, *,
                     rounded: bool) -> torch.Tensor:
    """Elements one quantize event clips to the rail or received
    non-finite, as an int64 scalar.  ``y`` is the scaled (pre-clip)
    value, ``finite`` the finiteness of the source."""
    mag = torch.abs(torch.round(y)) if rounded else torch.abs(y)
    return ((~finite) | (finite & (mag > qmax))).sum()


# -- the collective wire's block rule ----------------------------------------
def _blocks(x: torch.Tensor) -> torch.Tensor:
    """``x`` zero-padded to whole blocks, ``[blocks, QUANT_BLOCK_ELEMS]``."""
    pad = scale_count(x.numel()) * QUANT_BLOCK_ELEMS - x.numel()
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(-1, QUANT_BLOCK_ELEMS)


def quantize_blocks(x: torch.Tensor, fmt: WireFormat):
    """Quantize flat f32 ``x`` on the per-chunk scale grid: ``(q, scales,
    sat)``, the payload in ``fmt``'s dtype (``x``'s length), one scale per
    block, and the f32 count of elements clipped to the rail or received
    non-finite.  The zero padding of a ragged last block quantizes
    exactly and never counts."""
    n = x.numel()
    xb = _blocks(x.float())
    finite = torch.isfinite(xb)
    amax = torch.where(finite, xb.abs(), torch.zeros_like(xb)).amax(dim=1)
    scales = chunk_scale(amax, fmt.qmax)
    y = xb / scales[:, None]
    rounded = fmt.name == "int8"
    sat = saturation_count(y, finite, fmt.qmax, rounded=rounded)
    q = quantize_values(y, fmt.qmax, wire_dtype(fmt), rounded=rounded)
    return q.reshape(-1)[:n], scales, sat.to(torch.float32)


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`quantize_blocks`: f32 values, same length."""
    n = q.numel()
    return (_blocks(q.float()) * scales[:, None]).reshape(-1)[:n]


def _fused_multiply_add(q: torch.Tensor, scales: torch.Tensor,
                        addend: torch.Tensor, sign: float) -> torch.Tensor:
    """``addend + sign * q * scale`` rounded to f32 once.  The product of a
    one-byte payload and an f32 scale is exact in f64, so the f64 sum
    rounds as one FMA does (barring a double rounding too rare to meet)."""
    n = q.numel()
    prod = (_blocks(q.double()) * scales.double()[:, None]).reshape(-1)[:n]
    return (addend.double() + sign * prod).float()


def dequantize_add(q: torch.Tensor, scales: torch.Tensor,
                   chunk: torch.Tensor) -> torch.Tensor:
    """``dequantize_blocks(q, scales) + chunk`` as the JAX package's
    compiled programs compute it: XLA contracts the product and the sum
    into one FMA, jitted and inside the Pallas hop kernel alike, so the
    partial sum carries one rounding, not two."""
    return _fused_multiply_add(q, scales, chunk, 1.0)


def quantization_error(x: torch.Tensor, q: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """``x - dequantize_blocks(q, scales)``, one rounding (an FMA, as
    the JAX package's compiled programs compute it)."""
    return _fused_multiply_add(q, scales, x, -1.0)
