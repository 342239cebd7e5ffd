"""The numerics step policy: its configuration and ``fit``'s host side.

Port of the JAX package's ``numerics/policy.py``.  ``on_nonfinite`` says
what a bad step costs:

* ``"skip"`` (default): the step applies no update (params and optimizer
  state bit-identical), the loss scale backs off, the skip is counted;
* ``"raise"`` and ``"rollback"``: the same step, plus a host policy that
  :func:`~autodist_tpu_torch.fit.fit` applies through
  :class:`StepHealthMonitor` (raise :class:`NonFiniteError`, or restore
  the last verified-good checkpoint, write a supervisor failure marker
  and go on).  The step itself behaves as under ``"skip"``, as in the JAX
  package.

The config rides ``AutoDist.capture(numerics=...)``.  The monitor takes
no injected loss spikes: the JAX package's chaos harness that injects
them is P9.
"""
from __future__ import annotations

import json
import logging
import math
import os
import socket
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Optional

from autodist_tpu_torch.const import ENV

log = logging.getLogger(__name__)

#: the exit code a numerics failure marker carries
NUMERICS_MARKER_CODE = 74
#: the supervisor's marker file name prefix
_MARKER_PREFIX = "failure_"

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


@dataclass
class RollbackRequest(Exception):
    """Internal signal from the step loop to ``fit``'s rollback handler
    (an Exception so it unwinds the epoch loop cleanly)."""

    step: int
    reason: str

    def __str__(self):
        return f"rollback requested at step {self.step}: {self.reason}"


class StepHealthMonitor:
    """Host-side per-step health tracking for the ``raise``/``rollback``
    policies and the loss-spike detector.  ``observe`` returns None
    (healthy), ``"raise"`` or ``"rollback"``."""

    #: minimum finite-loss samples before the z-score test is trusted.
    MIN_SAMPLES = 8

    def __init__(self, config: NumericsConfig,
                 policy: Optional[str] = None):
        self.config = config
        self.policy = policy or config.on_nonfinite
        self._bad = 0
        self._losses: deque = deque(maxlen=config.spike_window)

    @property
    def bad_streak(self) -> int:
        """Current run of consecutive unhealthy steps."""
        return self._bad

    def reset(self) -> None:
        """After a rollback restore: the bad-step streak clears.  The loss
        window is kept: it describes the healthy trajectory the restore
        rejoined, so the spike detector stays armed through the replayed
        steps."""
        self._bad = 0

    def observe(self, step: int, loss: float,
                all_finite: bool) -> Optional[str]:
        spiked = False
        if all_finite and math.isfinite(loss):
            if (self.config.spike_zscore is not None
                    and len(self._losses) >= self.MIN_SAMPLES):
                n = len(self._losses)
                mean = sum(self._losses) / n
                std = math.sqrt(sum((x - mean) ** 2 for x in self._losses)
                                / n)
                if std > 0 and (loss - mean) / std > self.config.spike_zscore:
                    spiked = True
                    log.warning(
                        "numerics: loss spike at step %d (%.4g vs window "
                        "mean %.4g, z > %.1f)", step, loss, mean,
                        self.config.spike_zscore)
            if not spiked:
                self._losses.append(loss)
                self._bad = 0
                return None
        self._bad += 1
        if not all_finite and self.policy == "raise":
            return "raise"
        if self.policy == "rollback" and (
                spiked or self._bad >= self.config.rollback_after):
            return "rollback"
        return None


def write_failure_marker(marker_dir: str, address: str, code: int,
                         reason: Optional[str] = None) -> str:
    """The supervisor's failure marker (the JAX package's
    ``resilience/supervisor.py:137-151``: ``failure_<address>.json`` with
    ``address``, ``code``, ``time`` and an optional ``reason``), written
    atomically."""
    os.makedirs(marker_dir, exist_ok=True)
    safe = address.replace("/", "_").replace(":", "_")
    path = os.path.join(marker_dir, f"{_MARKER_PREFIX}{safe}.json")
    payload = {"address": address, "code": int(code), "time": time.time()}
    if reason:
        payload["reason"] = str(reason)
    with open(path + ".tmp", "w", encoding="utf-8") as f:
        json.dump(payload, f)
    os.replace(path + ".tmp", path)
    return path


def emit_failure_marker(reason: str) -> Optional[str]:
    """Write a numerics failure marker into the supervisor's marker
    directory (``AUTODIST_SUPERVISOR_DIR``) when one is set; the path, or
    None."""
    marker_dir = ENV.AUTODIST_SUPERVISOR_DIR.val
    if not marker_dir:
        return None
    path = write_failure_marker(marker_dir, socket.gethostname(),
                                NUMERICS_MARKER_CODE, reason=reason)
    log.warning("numerics: failure marker written to %s (%s)", path,
                   reason)
    return path
