"""The serving kernels' launch choices and K10's design probes on the card.

    python3 -m autodist_tpu_torch.profile_serving

Measures, with ``device_timer.Timer`` as ``chip_smoke.py`` times every
kernel, the numbers the wrappers' launch rules were chosen from, one JSON
line per group:

1. ``k9_splits``: K9 (paged attention) at the engine's decode shape (8
   slots, 12 heads x 64, block 32, the full 1024-position window) with
   1 to 8 blocks per (slot, head) (``fused_kernels.splits_for`` picks
   one);
2. ``k10_skinny_cluster``: K10's skinny kernel at M = 8 and the model's
   four (K, N), with clusters of 1 to 8 blocks along K
   (``quant.skinny_cluster``);
3. ``k10_tiled``: K10's tiled kernel at M = 512 and 2048 for each tile
   variant and K split of 1, 2 and 4, beside ``torch.matmul`` against
   the pre-dequantized weight (``quant.tiled_variant``,
   ``quant.tiled_split``);
4. ``k10_probe``: ``csrc/int8_matmul.cu`` built as it is and with each of
   :data:`PROBES`' text substitutions, which take one part of the tiled
   kernel's work away (its results are then wrong) or change its
   pipeline, timed at the prefill shapes in turns (as is first and last).

Needs a CUDA device and ``nvcc``; exits 2 without them.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from autodist_tpu_torch.device_timer import Timer

SOURCE = "int8_matmul.cu"
#: the model's (K, N): q/k/v/o, the MLP's two kernels, the tied head
MODEL_KN = ((768, 768), (768, 3072), (3072, 768), (768, 32128))
_MMA2 = "  mma_tf32(p, a, lo0, lo1);\n  mma_tf32(p, a, hi0, hi1);\n"
#: text substitutions in ``csrc/int8_matmul.cu``, each a probe of what
#: the tiled kernel spends its time on
PROBES = {
    # four FMAs in place of the two mmas of a k-step
    "no_mma": [(_MMA2,
                "  p[0] = fmaf(__uint_as_float(a[0]), __uint_as_float(lo0),"
                " p[0]);\n"
                "  p[1] = fmaf(__uint_as_float(a[1]), __uint_as_float(hi0),"
                " p[1]);\n"
                "  p[2] = fmaf(__uint_as_float(a[2]), __uint_as_float(lo1),"
                " p[2]);\n"
                "  p[3] = fmaf(__uint_as_float(a[3]), __uint_as_float(hi1),"
                " p[3]);\n")],
    # one TF32 mma per k-step (x's hi half only)
    "one_mma": [(_MMA2, "  mma_tf32(p, a, hi0, hi1);\n")],
    # no tile is copied to shared memory
    "no_loads": [("  constexpr int BK = C::kBK, LDR = C::kLdRaw;\n",
                  "  constexpr int BK = C::kBK, LDR = C::kLdRaw;\n"
                  "  if (M >= 0) return;\n")],
    # no split pass of x
    "no_split": [("i < BM * (BK / 4); i += kTiledThreads) {",
                  "i < 0; i += kTiledThreads) {")],
    # 32-row tiles, twice the stages in flight
    "deep_pipeline": [("Tiled<2, 2, 64, 4>", "Tiled<2, 2, 32, 8>"),
                      ("Tiled<4, 2, 64, 4>", "Tiled<4, 2, 32, 8>"),
                      ("Tiled<4, 4, 32, 3>", "Tiled<4, 4, 32, 6>")],
}


def _weight(gen, k, n):
    from autodist_tpu_torch.ops import quant

    return quant.quantize_weight((torch.randn(k, n, generator=gen)
                                  / k ** 0.5).to("cuda"))


def k9_splits(timer, gen) -> dict:
    from autodist_tpu_torch.ops import _build
    from autodist_tpu_torch.ops import fused_kernels as fk

    b, h, dh, bs, maxb = 8, 12, 64, 32, 32
    nb = b * maxb + maxb + 1
    q = torch.randn(b, h, dh, generator=gen).to("cuda")
    kc = torch.randn(nb, bs, h, dh, generator=gen).to("cuda")
    vc = torch.randn(nb, bs, h, dh, generator=gen).to("cuda")
    bt = torch.randint(1, nb, (b, maxb), generator=gen).to("cuda",
                                                          torch.int32)
    rel = torch.full((b,), maxb * bs - 1, dtype=torch.int32, device="cuda")
    sms = _build.sm_count(q.device)
    return {"group": "k9_splits", "default": fk.splits_for(b, h, maxb * bs,
                                                           sms),
            "ms": {s: timer(lambda: fk._launch(q, kc, vc, bt, rel, s))
                   for s in range(1, 9)}}


def k10_skinny_cluster(timer, gen) -> list:
    from autodist_tpu_torch.ops import _build, quant

    sms = _build.sm_count(torch.device("cuda"))
    rows = []
    for k, n in MODEL_KN:
        w = _weight(gen, k, n)
        x = torch.randn(8, k, generator=gen).to("cuda")
        rows.append({"group": "k10_skinny_cluster", "M": 8, "K": k, "N": n,
                     "default": quant.skinny_cluster(n, k, sms),
                     "ms": {c: timer(lambda: quant._launch(x, w, "skinny",
                                                           cluster=c))
                            for c in range(1, 9)}})
    return rows


def k10_tiled(timer, gen) -> list:
    from autodist_tpu_torch.ops import quant

    rows = []
    for m in (512, 2048):
        for k, n in MODEL_KN:
            w = _weight(gen, k, n)
            wdeq = w.q.float() * w.scale
            x = torch.randn(m, k, generator=gen).to("cuda")
            ms = {f"v{v}s{s}": timer(lambda: quant._launch(
                      x, w, "tiled", cluster=s, variant=v))
                  for v in (1, 2, 3) for s in (1, 2, 4)}
            rows.append({"group": "k10_tiled", "M": m, "K": k, "N": n,
                         "default": [quant.tiled_variant(m, n, k),
                                     quant.tiled_split(n, k)],
                         "library_ms": timer(lambda: torch.matmul(x, wdeq)),
                         "ms": ms})
    return rows


def k10_probes(timer, gen) -> list:
    """Each probe's time at the prefill shapes, under the wrappers' own
    launch choices."""
    from autodist_tpu_torch import profile_flash
    from autodist_tpu_torch.ops import quant

    built = profile_flash.build_variants(SOURCE, PROBES)
    names = list(built)
    order = names + names[1:] + names[:1]       # as is first and last
    rows = []
    for m, k, n in ((512, 768, 768), (512, 3072, 768), (512, 768, 3072),
                    (512, 768, 32128)):
        w = _weight(gen, k, n)
        x = torch.randn(m, k, generator=gen).to("cuda")
        ms = {name: [] for name in names}
        for name in order:
            profile_flash.use_library(built[name][0], SOURCE)
            ms[name].append(timer(lambda: quant._launch(x, w, "tiled")))
        rows.append({"group": "k10_probe", "M": m, "K": k, "N": n,
                     "ms": ms})
    profile_flash.use_library(built["as_is"][0], SOURCE)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(0)
    timer = Timer()
    rows = [k9_splits(timer, gen), *k10_skinny_cluster(timer, gen),
            *k10_tiled(timer, gen), *k10_probes(timer, gen)]
    for row in rows:
        print(json.dumps({"card": smi, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
