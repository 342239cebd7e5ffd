"""The numerics step policy's configuration.

Port of the JAX package's ``numerics/policy.py:31-100``.  ``on_nonfinite``
says what a bad step costs:

* ``"skip"`` (default): the step applies no update (params and optimizer
  state bit-identical), the loss scale backs off, the skip is counted;
* ``"raise"`` and ``"rollback"``: the same step, plus a host policy that
  ``fit`` applies (raise :class:`NonFiniteError`, or restore the last
  verified-good checkpoint).  ``fit`` and its health monitor come with
  P5; the step itself behaves as under ``"skip"``, as in the JAX package.

The config rides ``AutoDist.capture(numerics=...)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

ON_NONFINITE = ("skip", "raise", "rollback")


class NonFiniteError(RuntimeError):
    """A non-finite step under ``on_nonfinite="raise"``, or a rollback
    with no way to recover."""


@dataclass(frozen=True)
class NumericsConfig:
    """Everything the numerics guard needs, resolved at capture time.

    ``loss_scale``: ``"auto"`` (dynamic scaling iff params or gradient
    buckets are fp16/bf16), ``None`` (off), a number (static scale), or a
    :class:`~autodist_tpu_torch.numerics.LossScale`.  ``clip_norm``:
    global-norm clip threshold (the optimizer library's formula; exact
    under ZeRO-1).  ``spike_zscore``, ``spike_window``,
    ``rollback_after``, ``max_rollbacks`` and ``reseed_on_rollback``
    configure ``fit``'s host policy."""

    guard: bool = True
    clip_norm: Optional[float] = None
    loss_scale: Any = "auto"
    on_nonfinite: str = "skip"
    rollback_after: int = 3
    spike_zscore: Optional[float] = None
    spike_window: int = 32
    max_rollbacks: int = 2
    reseed_on_rollback: bool = True

    def __post_init__(self):
        if self.on_nonfinite not in ON_NONFINITE:
            raise ValueError(
                f"on_nonfinite must be one of {ON_NONFINITE}, "
                f"got {self.on_nonfinite!r}")
        if self.clip_norm is not None and self.clip_norm <= 0:
            raise ValueError("clip_norm must be > 0 (or None)")
        if self.rollback_after < 1:
            raise ValueError("rollback_after must be >= 1")
        if self.spike_window < 4:
            raise ValueError("spike_window must be >= 4")

    @staticmethod
    def coerce(value) -> Optional["NumericsConfig"]:
        """Normalize ``capture(numerics=...)``: None/False (off), True
        (defaults), one of :data:`ON_NONFINITE` (defaults with that
        policy), a dict of fields, or a config instance."""
        if value is None or value is False:
            return None
        if value is True:
            return NumericsConfig()
        if isinstance(value, str):
            return NumericsConfig(on_nonfinite=value)
        if isinstance(value, dict):
            return NumericsConfig(**value)
        if isinstance(value, NumericsConfig):
            return value
        raise ValueError(
            "numerics must be None/bool, an on_nonfinite string, a dict "
            f"of NumericsConfig fields, or a NumericsConfig; got {value!r}")
