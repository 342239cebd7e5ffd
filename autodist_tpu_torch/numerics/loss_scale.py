"""Loss scaling: configuration, pure rules, and the step-state transition.

Port of the JAX package's ``numerics/loss_scale.py``.  The loss is
multiplied by ``scale`` before the backward pass, the reduced gradients are
divided by it before clipping and the update, and a dynamic scale backs
off when a step had non-finite gradients and grows after
``growth_interval`` clean steps.  Factors are powers of two by default, so
scaling and unscaling are exact.

The rules (activation, wire saturation) are pure functions of dtypes and
config.  The state is a dict of scalar tensors on the step's device,
carried in the session's sync state; :func:`update_state` is one
transition of it, computed on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

#: dtypes that turn ``loss_scale="auto"`` on
LOW_PRECISION_DTYPES = ("float16", "bfloat16")

#: headroom between the largest loss-scaled gradient the wire rule
#: assumes (|g| * scale with |g| up to this factor) and the wire dtype's
#: finite max
WIRE_HEADROOM = 1e4


@dataclass(frozen=True)
class LossScale:
    """Loss-scale configuration.  ``dynamic=False`` freezes the scale at
    ``init`` (non-finite steps still skip).  Defaults: start high, halve on
    overflow, double after ``growth_interval`` clean steps, clamped to
    ``[min_scale, max_scale]``."""

    init: float = 2.0 ** 15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24
    dynamic: bool = True

    def __post_init__(self):
        if self.init <= 0:
            raise ValueError(f"loss scale init must be > 0, got {self.init}")
        if self.growth_factor < 1 or self.backoff_factor > 1 \
                or self.backoff_factor <= 0:
            raise ValueError(
                "loss scale needs growth_factor >= 1 and 0 < backoff_factor "
                f"<= 1, got {self.growth_factor}/{self.backoff_factor}")
        if self.growth_interval < 1:
            raise ValueError("growth_interval must be >= 1")


def is_low_precision(dtype) -> bool:
    return str(dtype).replace("torch.", "") in LOW_PRECISION_DTYPES


def resolve_loss_scale(spec, dtypes: Sequence[str]) -> Optional[LossScale]:
    """The effective loss-scale config for a program whose parameters and
    gradient buckets carry ``dtypes``: ``"auto"``/True (the default
    dynamic schedule iff any dtype is fp16/bf16), ``None``/``"none"``/
    ``"off"``/False (off), a number (a STATIC scale), or a
    :class:`LossScale`.  None when scaling is off (scale == 1 exactly)."""
    if spec is None or spec in ("none", "off", False):
        return None
    if isinstance(spec, LossScale):
        return spec
    if spec == "auto" or spec is True:
        if any(is_low_precision(d) for d in dtypes):
            return LossScale()
        return None
    if isinstance(spec, (int, float)):
        return LossScale(init=float(spec), dynamic=False)
    raise ValueError(
        f"loss_scale must be 'auto', None, a number, or a LossScale; "
        f"got {spec!r}")


def wire_dtype_of(compressor: str) -> Optional[str]:
    """The float dtype a compressor puts on the wire where a large loss
    scale can saturate it (the bf16-cast compressors), else None."""
    if compressor in ("HorovodCompressor", "HorovodCompressorEF"):
        return "bfloat16"
    return None


def scale_saturates_wire(scale: Optional[LossScale],
                         compressor: str) -> Optional[str]:
    """Why this (loss scale, compressor) pair can saturate the
    compressor's wire dtype, or None: the largest scale the schedule can
    reach times :data:`WIRE_HEADROOM` must stay below the wire dtype's
    finite max."""
    if scale is None:
        return None
    wire = wire_dtype_of(compressor)
    if wire is None:
        return None
    peak = scale.max_scale if scale.dynamic else scale.init
    wire_max = float(torch.finfo(getattr(torch, wire)).max)
    if peak * WIRE_HEADROOM > wire_max:
        return (f"loss scale can reach {peak:.3g}; gradients scaled that "
                f"far saturate the {compressor} {wire} wire "
                f"(finite max {wire_max:.3g}, headroom {WIRE_HEADROOM:.0e})")
    return None


# -- step-state transition (on the device) ----------------------------------

def init_state(scale: Optional[LossScale],
               device="cpu") -> Dict[str, torch.Tensor]:
    """The numerics step state: loss scale and health counters, scalar
    tensors on ``device``."""
    init = float(scale.init) if scale is not None else 1.0

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)
    return {"scale": torch.tensor(init, dtype=torch.float32, device=device),
            "good_steps": i32(0),
            "bad_steps": i32(0),        # consecutive non-finite steps
            "skipped": i32(0),          # cumulative skipped updates
            "step": i32(0)}             # device-side step counter


def update_state(state: Dict[str, torch.Tensor], all_finite: torch.Tensor,
                 scale: Optional[LossScale]) -> Dict[str, torch.Tensor]:
    """One transition given this step's health (a bool tensor): a clean
    step counts toward growth, a bad one backs the scale off and counts a
    skip.  With ``scale`` None the scale stays exactly 1."""
    ok = all_finite
    one = torch.ones((), dtype=torch.int32, device=ok.device)
    zero = torch.zeros_like(one)
    good = torch.where(ok, state["good_steps"] + 1, zero)
    bad = torch.where(ok, zero, state["bad_steps"] + 1)
    skipped = state["skipped"] + torch.where(ok, zero, one)
    s = state["scale"]
    if scale is not None and scale.dynamic:
        at = good >= scale.growth_interval
        grown = torch.where(at, s * scale.growth_factor, s)
        good = torch.where(at, zero, good)
        s = torch.where(ok, grown, s * scale.backoff_factor)
        s = torch.clamp(s, scale.min_scale, scale.max_scale)
    return {"scale": s.to(torch.float32),
            "good_steps": good.to(torch.int32),
            "bad_steps": bad.to(torch.int32),
            "skipped": skipped.to(torch.int32),
            "step": (state["step"] + 1).to(torch.int32)}
