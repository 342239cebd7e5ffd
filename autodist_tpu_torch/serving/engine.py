"""Serving-engine shared pieces: typed admission errors, per-slot sampling
and the device-resident prompt write.

Port of the parts of ``autodist_tpu/serving/engine.py`` the paged
scheduler uses (the slot-based ``DecodeEngine`` comes in a later slice).
"""
from __future__ import annotations

from typing import Optional

import torch

from autodist_tpu_torch.models.generate import sample_next_token

TEMPERATURE_FLOOR = 1e-6
"""Smallest accepted nonzero per-request temperature.  Below it the
scaled logits overflow f32 (|logit|/temp > f32 max) and the softmax
NaNs, so ``submit`` rejects the range instead of silently clamping —
``temperature=0`` is the supported way to ask for greedy."""


class AdmissionError(RuntimeError):
    """Typed backpressure: a submit was rejected because the request
    queue (or an SLO class's share of it) is full.  Carries a
    ``retry_after_s`` hint; the HTTP front answers 429 + Retry-After."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class DeadlineError(RuntimeError):
    """Typed deadline shed: the measured queue-wait/per-token percentiles
    say the request cannot finish inside its ``deadline_s``.  The HTTP
    front answers 503 + Retry-After with ``"shed": true``."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


def _sample_per_slot(logits: torch.Tensor, rng: Optional[torch.Generator],
                     temp: torch.Tensor, top_k: int, top_p: float,
                     any_sampled: bool = True) -> torch.Tensor:
    """Per-slot temperature over one logits batch [B, V]: rows with
    ``temp[b] == 0`` take the argmax, others sample from
    ``logits / temp[b]`` through the engine-wide top-k/top-p filters
    (``sample_next_token`` at temperature 1.0 on the pre-scaled logits).
    ``any_sampled=False`` (the host knows every row is greedy) skips the
    sampling branch, and with it the noise draw."""
    greedy = torch.argmax(logits, dim=-1)
    if not any_sampled:
        return greedy
    scaled = logits.float() / torch.clamp(temp, min=TEMPERATURE_FLOOR)[:, None]
    sampled = sample_next_token(scaled, rng, 1.0, top_k, top_p)
    return torch.where(temp > 0.0, sampled, greedy)


def _write_prompt_program(tokens: torch.Tensor, prompt_pb: torch.Tensor,
                          slot_b: int, t0: int) -> None:
    """Prompt write into the device-resident token buffer, in place: row
    ``slot_b``, positions ``(t0 .. t0+Pb-1) % window`` (pow-2 bucket; the
    pad tail lands on positions the slot writes before reading)."""
    idx = (t0 + torch.arange(prompt_pb.shape[0], device=tokens.device)) \
        % tokens.shape[1]
    tokens[slot_b, idx] = prompt_pb.to(tokens.dtype)
