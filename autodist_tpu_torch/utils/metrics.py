"""Throughput instrumentation.

Port of the JAX package's ``utils/metrics.py``: :class:`ThroughputMeter`
is fed by every ``DistributedSession.run``.  The card's peak rate and the
session's model FLOPs live on the session (``runner.PEAK_BF16_FLOPS``,
``DistributedSession.flops_per_step``/``mfu``): the JAX module's TPU peak
table and its compiled-program cost analysis have no counterpart here.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional


class ThroughputMeter:
    """Sliding-window step-time tracker (wall time between ``tick()``s).

    With ``sess.run(sync=False)`` this measures the dispatch rate until
    the card's queue fills, then the true step time."""

    def __init__(self, window: int = 50):
        self._times: deque = deque(maxlen=window + 1)

    def tick(self) -> None:
        self._times.append(time.perf_counter())

    @property
    def steps_recorded(self) -> int:
        return max(0, len(self._times) - 1)

    def step_time(self) -> Optional[float]:
        """Mean seconds per step over the window (None until 2 ticks)."""
        if len(self._times) < 2:
            return None
        return (self._times[-1] - self._times[0]) / (len(self._times) - 1)

    def stats(self, items_per_step: Optional[int] = None) -> Dict[str, Any]:
        st = self.step_time()
        out: Dict[str, Any] = {
            "steps_measured": self.steps_recorded,
            "step_time_ms": None if st is None else round(st * 1e3, 3),
            "steps_per_sec": None if st in (None, 0.0) else round(1.0 / st,
                                                                  3),
        }
        if items_per_step is not None and st not in (None, 0.0):
            out["items_per_sec"] = round(items_per_step / st, 2)
        return out
