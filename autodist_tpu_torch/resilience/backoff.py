"""Exponential backoff with deterministic jitter.

Port of the JAX package's ``resilience/backoff.py``.  The one retry
schedule the resilience consumers share: the job supervisor's relaunch
loop (``resilience/supervisor.py``) and the per-worker restart policy
delay through it, so "how long until we try again" is one tested rule.

Jitter spreads each delay over ``±jitter/2`` of its nominal value, so a
fleet that failed at once does not relaunch in lockstep; a ``seed``
makes the spread deterministic (Python's ``random.Random`` seeded
``seed * 1000003 + attempt``, as in the JAX package, so the same seed
gives the same delays in both packages).
"""
from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Backoff:
    """Bounded exponential backoff schedule.

    ``max_tries`` counts ATTEMPTS, not retries: ``max_tries=3`` means one
    initial try plus up to two retries.  ``delay(i)`` is the pause after
    failed attempt ``i`` (1-based): ``base * multiplier**(i-1)`` capped
    at ``cap``, spread over ``±jitter/2`` of itself (mean preserved).
    """

    max_tries: int = 3
    base: float = 0.5
    cap: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.5
    seed: Optional[int] = None

    def __post_init__(self):
        if self.max_tries < 1:
            raise ValueError("max_tries must be >= 1")
        if self.base < 0 or self.cap < 0:
            raise ValueError("base/cap must be >= 0")
        if not 0 <= self.jitter <= 1:
            raise ValueError("jitter must be in [0, 1]")

    def nominal(self, attempt: int) -> float:
        """Un-jittered delay after failed attempt ``attempt`` (1-based)."""
        if attempt < 1:
            raise ValueError("attempt is 1-based")
        return min(self.cap, self.base * self.multiplier ** (attempt - 1))

    def delay(self, attempt: int) -> float:
        d = self.nominal(attempt)
        if self.jitter == 0 or d == 0:
            return d
        # a pure function of (schedule, attempt) when seeded: a restarted
        # supervisor replays the same timeline
        rng = random.Random(self.seed * 1000003 + attempt) \
            if self.seed is not None else random
        return d * (1 - self.jitter / 2 + self.jitter * rng.random())

    def delays(self) -> Sequence[float]:
        """The full retry schedule (``max_tries - 1`` pauses)."""
        return [self.delay(i) for i in range(1, self.max_tries)]

    def retry(self, fn: Callable, *, retryable: Tuple = (Exception,),
              label: str = "", sleep: Callable[[float], None] = time.sleep):
        """Call ``fn`` up to ``max_tries`` times; re-raise the last error.
        Every retry is logged with its attempt count; errors that are not
        ``retryable`` propagate at once."""
        for attempt in range(1, self.max_tries + 1):
            try:
                return fn()
            except retryable as e:
                if attempt >= self.max_tries:
                    raise
                pause = self.delay(attempt)
                log.warning(
                    "%s: attempt %d/%d failed (%s); retrying in %.2fs",
                    label or getattr(fn, "__name__", "call"), attempt,
                    self.max_tries, e, pause)
                sleep(pause)
