#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``train_ring`` phase (the two quantized-ring
configurations, ``ps_lb`` and ``train_p6``: 4 gloo ranks sharing one
card) of the checkout at CHECKOUT and print its numbers, digests left
out, as one line ``PROBE {json}``.  Two checkouts of the repo measured in
one session compare the phase's step times and per-rank memory:

    python3 chip_ring_probe.py CHECKOUT LABEL
"""
import json
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs  # noqa: E402
from autodist_tpu_torch.ops import _build  # noqa: E402

t = time.perf_counter()
_build.build_all()
build_s = time.perf_counter() - t
ring, wall, _ = cs.phase_train_ring()
out = {"checkout": sys.argv[2], "card": cs.nvidia_smi(), "build_s": build_s,
       "ring_wall_s": wall}
for name, res in ring.items():
    if isinstance(res, dict):
        out[name] = {k: v for k, v in res.items() if "sha" not in k}
print("PROBE " + json.dumps(out), flush=True)
