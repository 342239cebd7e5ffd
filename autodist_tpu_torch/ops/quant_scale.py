"""The symmetric-quantization scale rules, in PyTorch.

The port's own copy of ``autodist_tpu/ops/quant_scale.py`` for what the
weight-only int8 path needs (the collective-wire ``chunk_scale`` rule
comes with the quantized ring kernels):

* :func:`channel_scale` (stored weights): ``amax / qmax`` with all-zero
  channels pinned at the identity scale 1.0 — the stored scale is
  long-lived model state and an identity scale is the honest "nothing
  here" marker;
* :func:`quantize_values`: clip the scaled values to the rail and cast,
  rounding to nearest-even first on the integer grid.
"""
from __future__ import annotations

import torch


def channel_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """Per-output-channel stored-weight scale: ``amax / qmax`` with
    all-zero channels pinned at 1.0."""
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def quantize_values(y: torch.Tensor, qmax: float, wire_dtype, *,
                    rounded: bool) -> torch.Tensor:
    """Clip ``y`` (already divided by its scale) to ``±qmax`` and cast.
    ``rounded=True`` rounds half to even before the clip (the int8
    rule, as ``jnp.round``)."""
    if rounded:
        y = torch.round(y)
    return torch.clamp(y, -qmax, qmax).to(wire_dtype)
