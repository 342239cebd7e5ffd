"""Where a paged decode tick's time goes on the card.

    python3 -m autodist_tpu_torch.profile_decode [--int8]

Serves ``transformer_lm()`` at its defaults (random weights from seed 0)
through a ``PagedDecodeEngine`` (8 slots, window 1024, block 32) and
warms up.  Then, for each batch state of ``LIVE_SLOTS`` (every slot
busy; half the slots busy beside cancelled ones), it times ``WINDOWS``
windows of ``TICKS`` decode ticks, records one more window under
``torch.profiler``, and prints one JSON line: the host wall time per
tick (median, min and max over the unprofiled windows: the host is
shared and its times spread), the device busy time per tick (union of
kernel intervals) and the idle share it leaves at the median wall time,
and device time and kernel launches per tick grouped by kernel (the
port's two CUDA kernels, cuBLAS GEMMs, everything else).  A last line
gives the host time to issue one projection (plain matmul, int8 kernel)
and one paged-attention call.  Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

#: decode ticks per timed window, unprofiled windows per batch state,
#: and the batch states: all 8 slots live, then 4 live beside 4 dead
#: (cancelled) slots, as a mixed serving load leaves them
TICKS = 32
WINDOWS = 5
LIVE_SLOTS = (8, 4)


def _group(name: str) -> str:
    if "paged_attention" in name:
        return "paged_attention"
    if "int8_matmul" in name:
        return "int8_matmul"
    if "gemm" in name or "gemv" in name or "sm90_xmma" in name \
            or "cutlass" in name:
        return "gemm"
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


def _host_us_per_call(calls: int = 200) -> dict:
    """Host time to issue one call at the decode shapes: a projection as
    a plain matmul and as the int8 kernel, and one layer's paged
    attention.  Fewer calls than the launch queue holds, so the host never
    waits on the card."""
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.ops import quant

    dev = torch.device("cuda")
    x = torch.randn(8, 768, device=dev)
    w = torch.randn(768, 768, device=dev) / 768 ** 0.5
    wq = quant.quantize_weight(w)
    q = torch.randn(8, 12, 64, device=dev)
    kc = torch.randn(289, 32, 12, 64, device=dev)
    bt = torch.randint(1, 289, (8, 32), dtype=torch.int32, device=dev)
    rel = torch.full((8,), 127, dtype=torch.int32, device=dev)
    out = {}
    for name, fn in (
            ("matmul", lambda: x @ w),
            ("int8_matmul", lambda: quant.int8_matmul(x, wq)),
            ("paged_attention", lambda: fk.paged_attention(q, kc, kc, bt,
                                                           rel))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--int8", action="store_true",
                    help="serve the weight-only int8 tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from autodist_tpu_torch.models.quantize import quantize_lm_params
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.serving import PagedDecodeEngine

    spec = transformer_lm()
    params = spec.init(0, device="cuda")
    if args.int8:
        params = quantize_lm_params(params)
    eng = PagedDecodeEngine(spec, params, slots=8, window=1024,
                            block_size=32, chunk=16, prefill_chunk=256,
                            device="cuda")
    rng = np.random.RandomState(0)
    vocab = spec.config["vocab_size"]

    def fill(max_new):
        ids = [eng.submit(rng.randint(0, vocab, 64), max_new)
               for _ in range(8)]
        while True:             # admit + prefill (and the first chunks)
            st = eng.scheduler_stats()
            if not (st["prefilling"] or st["queue_depth_total"]):
                return ids
            eng.step()

    def window():
        torch.cuda.synchronize()
        eng.timeline.clear()
        t0 = time.perf_counter()
        ticks = 0
        while ticks < TICKS:
            eng.step()
            ticks = sum(e[1] for e in eng.timeline if e[0] == "decode")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6, ticks

    fill(64)                    # warm-up: every kernel and GEMM shape
    eng.run()
    for live in LIVE_SLOTS:
        ids = fill((WINDOWS + 1) * TICKS + 64)
        for rid in ids[live:]:  # their slots stay dead for the windows
            eng.cancel(rid)
        # the profiler's host-side tracing slows the host: the wall time
        # per tick comes from unprofiled windows of the same length
        walls = sorted(us / n for us, n in
                       (window() for _ in range(WINDOWS)))
        wall_us = statistics.median(walls)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_wall_us, prof_ticks = window()
        for rid in ids[:live]:
            eng.cancel(rid)
        eng.run()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            print("profile_decode: the profiler recorded no device time",
                  file=sys.stderr)
            return 1
        per_group: dict = {}
        for e in kernels:
            g = per_group.setdefault(_group(e.name), [0.0, 0])
            g[0] += e.time_range.end - e.time_range.start
            g[1] += 1
        busy_us_per_tick = _union_us((e.time_range.start, e.time_range.end)
                                     for e in kernels) / prof_ticks
        print(json.dumps({
            "tree": "int8" if args.int8 else "f32",
            "device": torch.cuda.get_device_name(0),
            "ticks_per_window": TICKS, "windows": WINDOWS,
            "live_slots": live, "dead_slots": 8 - live,
            "wall_ms_per_tick": wall_us / 1e3,
            "wall_ms_per_tick_min": walls[0] / 1e3,
            "wall_ms_per_tick_max": walls[-1] / 1e3,
            "profiled_wall_ms_per_tick": prof_wall_us / prof_ticks / 1e3,
            "device_busy_ms_per_tick": busy_us_per_tick / 1e3,
            "device_idle_share": 1.0 - busy_us_per_tick / wall_us,
            "kernels_per_tick": len(kernels) / prof_ticks,
            "device_ms_per_tick": {k: v[0] / prof_ticks / 1e3
                                   for k, v in sorted(per_group.items())},
            "launches_per_tick": {k: v[1] / prof_ticks
                                  for k, v in sorted(per_group.items())},
        }), flush=True)
    print(json.dumps({"host_us_per_call": _host_us_per_call()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
