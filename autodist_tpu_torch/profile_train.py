"""Where a full-width training step's time goes on the card.

    python3 -m autodist_tpu_torch.profile_train

Trains ``transformer_lm()`` at its defaults (random weights from seed 0)
through ``AutoDist(strategy_builder=AllReduce())`` with ``adamw(1e-3)`` on
one fixed batch of ``BATCH`` x 1024 tokens.  After
``WARMUP`` steps it times ``STEPS`` steps (``torch.cuda.synchronize()``
around each), records ``PROFILED`` more under ``torch.profiler`` and
prints one JSON line: the wall time per step (median, min, max), the
device busy time per step (union of kernel intervals) and the idle share
it leaves at the median wall time, and device time and launches per step
grouped by kernel (the flash kernels K1–K3, cuBLAS GEMMs, softmax, other
reductions, everything else).  Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import torch

WARMUP, STEPS, PROFILED = 3, 5, 2
BATCH = 8


def _group(name: str) -> str:
    for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
        if kernel + "_kernel" in name:
            return kernel
    if "gemm" in name or "sm90_xmma" in name or "cutlass" in name:
        return "gemm"
    if "softmax" in name.lower():
        return "softmax"
    if "reduce" in name.lower():
        return "reductions"
    return "other"


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.autodist import AutoDist
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.strategy import AllReduce

    spec = transformer_lm()
    ad = AutoDist(strategy_builder=AllReduce())
    with ad.scope():
        ad.capture(params=spec.init(0), optimizer=optim.adamw(1e-3),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars)
    sess = ad.create_distributed_session()
    batch = spec.sample_batch(BATCH)

    def step() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.run(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    for _ in range(WARMUP):
        step()
    walls = sorted(step() for _ in range(STEPS))
    wall_us = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_us = sum(step() for _ in range(PROFILED))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile_train: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    per_group: dict = {}
    for e in kernels:
        g = per_group.setdefault(_group(e.name), [0.0, 0])
        g[0] += e.time_range.end - e.time_range.start
        g[1] += 1
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels) / PROFILED
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "layers": spec.config["num_layers"], "batch": BATCH, "seq_len": spec.config["seq_len"],
        "steps": STEPS, "wall_ms_per_step": wall_us / 1e3,
        "wall_ms_per_step_min": walls[0] / 1e3,
        "wall_ms_per_step_max": walls[-1] / 1e3,
        "profiled_wall_ms_per_step": prof_wall_us / PROFILED / 1e3,
        "device_busy_ms_per_step": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernels_per_step": len(kernels) / PROFILED,
        "device_ms_per_step": {k: v[0] / PROFILED / 1e3
                               for k, v in sorted(per_group.items())},
        "launches_per_step": {k: v[1] / PROFILED
                              for k, v in sorted(per_group.items())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
