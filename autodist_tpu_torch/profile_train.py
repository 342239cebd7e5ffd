"""Where a full-width training step's time goes on the card.

    python3 -m autodist_tpu_torch.profile_train [--model NAME ...]

Each configuration trains its model at the repo's defaults (random weights
from seed 0) on one fixed batch through the facade.  ``--model
transformer_lm`` (the default) runs ``transformer_lm()`` on ``BATCH`` x
1024 tokens in three configurations, one after the other:

* ``allreduce``: ``AllReduce()`` with ``adamw(1e-3)`` (the plain step);
* ``zero1``: ``Zero1()`` with ``fusable_adam(1e-3)`` and
  ``numerics={"clip_norm": 1.0}`` (the explicit bucketed step: K4 guard
  statistics, K5 shard updates and the skip gate's host read);
* ``parallax``: ``Parallax()`` with the same optimizer and clip (the
  embedding's PS plan in a reduce-scatter bucket with K5, the dense
  variables in all-reduce buckets with the optimizer's per-leaf update).

``--model resnet50|vgg16|bert|lm1b`` runs that BASELINE model under its
BASELINE builder (BASELINE.json) at batch 32, the JAX examples'
``--batch-size``: ``resnet50()`` at 224x224 with ``AllReduce()`` and
``sgd(1e-3, momentum=0.9)``; ``vgg16()`` with ``PartitionedPS()``, the same
sgd and the clip; ``bert_base()`` at seq 128 with ``PartitionedAR()`` and
``adamw(1e-3)`` (non-causal K1–K3); ``lm1b()`` (vocabulary 793472, the
chunked loss) with ``Parallax()``, ``fusable_adam(1e-3)`` and the clip.
``--model densenet121|inception_v3`` runs that model (224x224, 299x299)
as ``imagenet.py`` does by default: ``AllReduce()`` and the same sgd at
batch 32; ``--model ncf`` runs ``ncf()`` at BASELINE's batch of 4096 under
``PSLoadBalancing()`` with ``fusable_adam(1e-3)`` and the clip (its four
tables in reduce-scatter buckets: K4 and K5).

For each, after ``WARMUP`` steps it times ``STEPS`` steps
(``torch.cuda.synchronize()`` around each), records ``PROFILED`` more under
``torch.profiler`` (one profile per step) and prints one JSON line: the
wall time per step (median, min, max), the device busy time per step
(union of kernel intervals) and the idle share it leaves at the median
wall time, device time and launches per step grouped by kernel (the flash
kernels K1–K3, K4 ``detect_stats``, K5 ``adam_update``, cuDNN
convolutions, cuBLAS GEMMs, norms, softmax, other reductions, copies,
everything else), and the device idle time that follows the step's first
device-to-host copy: under the guard, the skip gate's read of
``all_finite``, after which the card waits for the host to enqueue the
update.  Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

WARMUP, STEPS, PROFILED = 3, 5, 2
BATCH = 8
#: the BASELINE models' batch (the JAX examples' ``--batch-size``)
MODEL_BATCH = 32
#: NCF's batch (BASELINE.md's NCF row)
NCF_BATCH = 4096
CLIP_NORM = 1.0
#: ``--model`` → its configurations, in the order they run
MODELS = {"transformer_lm": ("allreduce", "zero1", "parallax"),
          "resnet50": ("resnet50",), "vgg16": ("vgg16",), "bert": ("bert",),
          "lm1b": ("lm1b",), "densenet121": ("densenet121",),
          "inception_v3": ("inception_v3",), "ncf": ("ncf",)}


def _group(name: str) -> str:
    for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
        if kernel + "_kernel" in name:
            return kernel
    if "detect_stats" in name:
        return "detect_stats"
    if "adam_update" in name:
        return "adam_update"
    low = name.lower()
    if any(k in low for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                              "implicit")):
        return "cudnn_conv"
    if "gemm" in low or "sm90_xmma" in low or "cutlass" in low:
        return "gemm"
    if "norm" in low:
        return "norms"
    if "softmax" in low:
        return "softmax"
    if "reduce" in low:
        return "reductions"
    if "memcpy" in low or "copy" in low:
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


def config(name: str):
    """``(spec, builder, optimizer, numerics, batch rows)`` of a
    configuration."""
    from autodist_tpu_torch import models, optim
    from autodist_tpu_torch import strategy as st
    from autodist_tpu_torch.ops.fused_kernels import fusable_adam

    clip = {"clip_norm": CLIP_NORM}
    sgd = optim.sgd(1e-3, momentum=0.9)
    return {
        "allreduce": (models.transformer_lm(), st.AllReduce(),
                      optim.adamw(1e-3), None, BATCH),
        "zero1": (models.transformer_lm(), st.Zero1(), fusable_adam(1e-3),
                  clip, BATCH),
        "parallax": (models.transformer_lm(), st.Parallax(),
                     fusable_adam(1e-3), clip, BATCH),
        "resnet50": (models.resnet50(), st.AllReduce(), sgd, None,
                     MODEL_BATCH),
        "vgg16": (models.vgg16(), st.PartitionedPS(), sgd, clip,
                  MODEL_BATCH),
        "bert": (models.bert_base(), st.PartitionedAR(), optim.adamw(1e-3),
                 None, MODEL_BATCH),
        "lm1b": (models.lm1b(), st.Parallax(), fusable_adam(1e-3), clip,
                 MODEL_BATCH),
        "densenet121": (models.densenet121(), st.AllReduce(), sgd, None,
                        MODEL_BATCH),
        "inception_v3": (models.inception_v3(), st.AllReduce(), sgd, None,
                         MODEL_BATCH),
        "ncf": (models.ncf(), st.PSLoadBalancing(), fusable_adam(1e-3), clip,
                NCF_BATCH),
    }[name]


def _session(name: str):
    import warnings

    from autodist_tpu_torch import autodist as adm

    spec, builder, opt, numerics, rows = config(name)
    adm._reset_default_autodist_for_testing()    # one facade per config
    ad = adm.AutoDist(strategy_builder=builder)
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"), optimizer=opt,
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   numerics=numerics)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # sgd's unfused shard update
        sess = ad.create_distributed_session()
    return spec, sess, spec.sample_batch(rows), rows


def _timed_step(sess, batch) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.run(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6


def profile_steps(sess, batch, profiled: int = PROFILED) -> dict:
    """``profiled`` steps of ``sess`` under ``torch.profiler``: per step,
    the wall µs under the profiler, the device busy µs (union of kernel
    intervals), kernels, device µs and launches per :func:`_group`, and
    the idle µs after the first device-to-host copy."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    per_group: dict = {}
    busy_us = prof_wall_us = gate_us = 0.0
    n_kernels = 0
    for _ in range(profiled):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            prof_wall_us += _timed_step(sess, batch)
        # kernels and copies; the device ranges of the step's
        # autodist_sync/ spans (user annotations) are not device work
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)),
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
    return {"profiled_wall_us": prof_wall_us / profiled,
            "busy_us": busy_us / profiled, "gate_us": gate_us / profiled,
            "kernels": n_kernels / profiled,
            "device_ms": {k: v[0] / profiled / 1e3
                          for k, v in sorted(per_group.items())},
            "launches": {k: v[1] / profiled
                         for k, v in sorted(per_group.items())}}


def profile(name: str) -> dict:
    spec, sess, batch, rows = _session(name)
    for _ in range(WARMUP):
        _timed_step(sess, batch)
    walls = sorted(_timed_step(sess, batch) for _ in range(STEPS))
    wall_us = statistics.median(walls)
    prof = profile_steps(sess, batch)
    out = {
        "config": name, "model": spec.name,
        "device": torch.cuda.get_device_name(0), "batch": rows,
        "model_config": spec.config, "steps": STEPS,
        "buckets": len(sess._step.buckets),
        "wall_ms_per_step": wall_us / 1e3,
        "wall_ms_per_step_min": walls[0] / 1e3,
        "wall_ms_per_step_max": walls[-1] / 1e3,
        "profiled_wall_ms_per_step": prof["profiled_wall_us"] / 1e3,
        "device_busy_ms_per_step": prof["busy_us"] / 1e3,
        "device_idle_share": 1.0 - prof["busy_us"] / wall_us,
        "idle_after_first_dtoh_copy_ms": prof["gate_us"] / 1e3,
        "kernels_per_step": prof["kernels"],
        "device_ms_per_step": prof["device_ms"],
        "launches_per_step": prof["launches"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    del sess
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", nargs="+", choices=sorted(MODELS),
                        default=["transformer_lm"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device available", file=sys.stderr)
        return 2
    for model in args.model:
        for name in MODELS[model]:
            print(json.dumps(profile(name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
