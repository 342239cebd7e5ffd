"""Where a full-width training step's time goes on the card.

    python3 -m autodist_tpu_torch.profile_train

Trains ``transformer_lm()`` at its defaults (random weights from seed 0)
on one fixed batch of ``BATCH`` x 1024 tokens through the facade, in three
configurations, one after the other:

* ``allreduce``: ``AllReduce()`` with ``adamw(1e-3)`` (the plain step);
* ``zero1``: ``Zero1()`` with ``fusable_adam(1e-3)`` and
  ``numerics={"clip_norm": 1.0}`` (the explicit bucketed step: K4 guard
  statistics, K5 shard updates and the skip gate's host read);
* ``parallax``: ``Parallax()`` with the same optimizer and clip (the
  embedding's PS plan in a reduce-scatter bucket with K5, the dense
  variables in all-reduce buckets with the optimizer's per-leaf update).

For each, after ``WARMUP`` steps it times ``STEPS`` steps
(``torch.cuda.synchronize()`` around each), records ``PROFILED`` more under
``torch.profiler`` (one profile per step) and prints one JSON line: the
wall time per step (median, min, max), the device busy time per step
(union of kernel intervals) and the idle share it leaves at the median
wall time, device time and launches per step grouped by kernel (the flash
kernels K1–K3, K4 ``detect_stats``, K5 ``adam_update``, cuBLAS GEMMs,
softmax, other reductions, copies, everything else), and the device idle
time that follows the step's first device-to-host copy: under the guard,
the skip gate's read of ``all_finite``, after which the card waits for the
host to enqueue the update.  Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import torch

WARMUP, STEPS, PROFILED = 3, 5, 2
BATCH = 8
CLIP_NORM = 1.0


def _group(name: str) -> str:
    for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
        if kernel + "_kernel" in name:
            return kernel
    if "detect_stats" in name:
        return "detect_stats"
    if "adam_update" in name:
        return "adam_update"
    if "gemm" in name or "sm90_xmma" in name or "cutlass" in name:
        return "gemm"
    if "softmax" in name.lower():
        return "softmax"
    if "reduce" in name.lower():
        return "reductions"
    if "memcpy" in name.lower() or "copy" in name.lower():
        return "copies"
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


def _session(name: str):
    from autodist_tpu_torch import optim
    from autodist_tpu_torch import autodist as adm
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.ops.fused_kernels import fusable_adam
    from autodist_tpu_torch.strategy import AllReduce, Parallax, Zero1

    spec = transformer_lm()
    adm._reset_default_autodist_for_testing()    # one facade per config
    bucketed = name != "allreduce"
    builder = {"allreduce": AllReduce, "zero1": Zero1,
               "parallax": Parallax}[name]()
    ad = adm.AutoDist(strategy_builder=builder)
    with ad.scope():
        ad.capture(params=spec.init(0),
                   optimizer=fusable_adam(1e-3) if bucketed
                   else optim.adamw(1e-3),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   numerics={"clip_norm": CLIP_NORM} if bucketed else None)
    return spec, ad.create_distributed_session()


def profile(name: str) -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    spec, sess = _session(name)
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
    per_group: dict = {}
    busy_us = prof_wall_us = gate_us = 0.0
    n_kernels = 0
    for _ in range(PROFILED):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            prof_wall_us += step()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if not events:
            raise RuntimeError("the profiler recorded no device time")
        n_kernels += len(events)
        for e in events:
            g = per_group.setdefault(_group(e.name), [0.0, 0])
            g[0] += e.time_range.end - e.time_range.start
            g[1] += 1
        busy_us += _union_us((e.time_range.start, e.time_range.end)
                             for e in events)
        dtoh = [i for i, e in enumerate(events)
                if "memcpy dtoh" in e.name.lower()]
        if dtoh and dtoh[0] + 1 < len(events):
            first = events[dtoh[0]]
            gate_us += max(0.0, events[dtoh[0] + 1].time_range.start
                           - first.time_range.end)
    busy_us /= PROFILED
    out = {
        "config": name, "device": torch.cuda.get_device_name(0),
        "layers": spec.config["num_layers"], "batch": BATCH,
        "seq_len": spec.config["seq_len"], "steps": STEPS,
        "buckets": len(sess._step.buckets),
        "wall_ms_per_step": wall_us / 1e3,
        "wall_ms_per_step_min": walls[0] / 1e3,
        "wall_ms_per_step_max": walls[-1] / 1e3,
        "profiled_wall_ms_per_step": prof_wall_us / PROFILED / 1e3,
        "device_busy_ms_per_step": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "idle_after_first_dtoh_copy_ms": gate_us / PROFILED / 1e3,
        "kernels_per_step": n_kernels / PROFILED,
        "device_ms_per_step": {k: v[0] / PROFILED / 1e3
                               for k, v in sorted(per_group.items())},
        "launches_per_step": {k: v[1] / PROFILED
                              for k, v in sorted(per_group.items())},
    }
    del sess
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device available", file=sys.stderr)
        return 2
    for name in ("allreduce", "zero1", "parallax"):
        print(json.dumps(profile(name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
