"""Kernel times on the card, as ``chip_smoke.py`` and ``profile_flash``
report them."""
from __future__ import annotations

import statistics

import torch


class Timer:
    """Median device time per call, with CUDA events.  Before each call
    the L2 cache (50 MB) is evicted by writing a 256 MB buffer, since the
    serving path reads each layer's weights and pool cold, and the card
    is held in a spin (``torch.cuda._sleep``) while the host enqueues the
    call, so the time is the card's and not the host's launch overhead."""

    SLEEP_CYCLES = 5_000_000     # ~2.5 ms at the H100's boost clock

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, iters: int = 50, warmup: int = 5) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SLEEP_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)
