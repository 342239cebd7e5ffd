"""K2 (``flash_dq_kernel``) design variants against each other on the card.

    python3 -m autodist_tpu_torch.profile_flash

Builds ``csrc/flash_attention.cu`` as it is and with each of
:data:`VARIANTS`' text substitutions (one ``nvcc -Xptxas -v`` per variant,
all started together, into ``build/kernels/variants/``), then for each
variant: holds dQ against :func:`flash_dq_reference` at the training shape
(B 8, T 1024, H 12, D 64, causal), at a ragged T = 1000 (causal and full),
at D = 8 and 16, and with q scaled by 4 (rtol/atol 1e-4, the same bits
twice), and times dQ at the training shape (``device_timer.Timer``, as
``chip_smoke.py`` times every kernel).  Variants are timed in
turns (as is, each variant, each variant again, as is), so that a
difference is not the card warming up.  One JSON line per variant: its
``ptxas`` registers, spills and shared memory for ``flash_dq_kernel<64,
causal>``, its largest error and its times; then one line with K3 and
SDPA's backward at the same shape for scale.  Needs a CUDA device and
``nvcc``; exits 2 without them.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from autodist_tpu_torch.device_timer import Timer

SHAPE = dict(B=8, T=1024, H=12, D=64)
_D_LOOP = "#pragma unroll\n    for (int d = 0; d < ND; ++d) {\n"
_S_DP_LOOP_END = "    // P = exp(S - lse), dS = P (dP - delta), in place of dP"
#: S and dP with one fresh fragment per two 8-wide steps (replaces the d
#: loop up to the line ``_S_DP_LOOP_END``)
_S_DP_TWO_STEPS = """    constexpr int SG = ND % 2 == 0 ? 2 : 1;   // k-steps per fresh fragment
#pragma unroll
    for (int d0 = 0; d0 < ND; d0 += SG) {
      FragA qa[SG], oa[SG];
#pragma unroll
      for (int u = 0; u < SG; ++u) {
        const float* qd = qb + (d0 + u) * 8;
        const float* qsd = qsb + (d0 + u) * 8;
        qa[u] = FragA{{lds32(qd), lds32(qd + 8 * LD), lds32(qd + 4),
                       lds32(qd + 8 * LD + 4)},
                      {lds32(qsd), lds32(qsd + 8 * LD), lds32(qsd + 4),
                       lds32(qsd + 8 * LD + 4)}};
        const float* dd = dob + (d0 + u) * 8;
        oa[u] = split_a(dd[0], dd[8 * LD], dd[4], dd[8 * LD + 4]);
      }
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        float p[4] = {0.f, 0.f, 0.f, 0.f}, r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < SG; ++u) {
          const int off = (n * 8 + g) * LD + (d0 + u) * 8 + t;
          mma3(p, qa[u], frag_b(lds32(kc + off), lds32(ksm + off),
                                lds32(kc + off + 4), lds32(ksm + off + 4)));
          mma3(r, oa[u], frag_b(lds32(vc + off), lds32(vsm + off),
                                lds32(vc + off + 4), lds32(vsm + off + 4)));
        }
        add_to(s[n], p);
        add_to(dp[n], r);
      }
    }

"""
#: name -> [(text in the source, its replacement)]; a replacement of
#: ``(start, end)`` replaces the text from ``start`` up to ``end``
VARIANTS = {
    "four_warps": [("constexpr int kDqWarps = 8;",
                    "constexpr int kDqWarps = 4;")],
    "d_unroll_2": [(_D_LOOP + "      const float* qd",
                    "#pragma unroll 2\n" + _D_LOOP[len("#pragma unroll\n"):]
                    + "      const float* qd")],
    "s_dp_two_steps": [((_D_LOOP + "      const float* qd", _S_DP_LOOP_END),
                        _S_DP_TWO_STEPS)],
    "long_group_8": [("constexpr int kLongGroup = 4;",
                      "constexpr int kLongGroup = 8;")],
}
SOURCE = "flash_attention.cu"
KERNEL = "flash_dq_kernel<64, causal>"


def _variant_source(text: str, subs) -> str:
    for old, new in subs:
        start, end = old if isinstance(old, tuple) else (old, None)
        if start not in text or (end is not None and end not in text):
            raise ValueError(f"variant substitution not found: {old!r}")
        i = text.index(start)
        j = text.index(end, i) if end is not None else i + len(start)
        text = text[:i] + new + text[j:]
    return text


def build_variants(source: str = SOURCE, variants=None) -> dict:
    """``{name: (library path, ptxas report)}`` for ``csrc/<source>`` as it
    is ("as_is") and every variant (default: this module's
    :data:`VARIANTS` of the flash source)."""
    from autodist_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / source).read_text()
    variants = VARIANTS if variants is None else variants
    procs = {}
    for name, subs in {"as_is": [], **variants}.items():
        src = out_dir / f"{Path(source).stem}-{name}.cu"
        src.write_text(_variant_source(text, subs))
        lib = src.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        built[name] = (lib, _build.parse_ptxas(log))
    return built


def use_library(path, source: str = SOURCE) -> None:
    """Makes the wrappers of ``csrc/<source>`` (the flash kernels unless
    given) launch from the library at ``path``."""
    from autodist_tpu_torch.ops import _build

    _build._libs[source] = ctypes.CDLL(str(path))
    for key in [k for k in _build._fns if k[0] == source]:
        del _build._fns[key]


def _inputs(gen, b, t, h, d, causal=True, mul=1.0):
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")

    q, k, v, do = (torch.randn(b, t, h, d, generator=gen).to("cuda")
                   for _ in range(4))
    q = q * mul
    dlse = torch.randn(b, h, t, generator=gen).to("cuda")
    o, lse = fa.flash_fwd_reference(q, k, v, causal)
    delta = ((do * o).sum(-1).transpose(1, 2) - dlse).contiguous()
    return q, k, v, do, lse, delta


def check_dq(gen) -> float:
    """dQ of the current library against the plain version on the checked
    shapes; returns the largest error."""
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")

    b, t, h, d = (SHAPE[x] for x in "BTHD")
    worst = 0.0
    for (bb, tt, hh, dd), causal, mul in (
            ((b, t, h, d), True, 1.0), ((b, 1000, h, d), True, 1.0),
            ((b, 1000, h, d), False, 1.0), ((2, 130, 2, 16), True, 1.0),
            ((2, 70, 3, 8), False, 1.0), ((2, 1024, 2, d), True, 4.0)):
        q, k, v, do, lse, delta = _inputs(gen, bb, tt, hh, dd, causal, mul)
        args = (q, k, v, do, lse, delta, causal)
        got = fa.flash_dq(*args)
        again = fa.flash_dq(*args)
        want = fa.flash_dq_reference(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                   msg=f"dQ at {(bb, tt, hh, dd)} "
                                       f"causal={causal} q x {mul}")
        if not torch.equal(got, again):
            raise AssertionError("dQ not bit-identical twice")
        worst = max(worst, (got - want).abs().max().item())
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_flash: no CUDA device available", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    built = build_variants()
    gen = torch.Generator().manual_seed(0)
    timer = Timer()
    b, t, h, d = (SHAPE[x] for x in "BTHD")
    q, k, v, do, lse, delta = _inputs(gen, b, t, h, d)
    args = (q, k, v, do, lse, delta, True)
    rows = {name: {"variant": name, "card": smi, "ptxas": rep.get(KERNEL),
                   "ms": []} for name, (_, rep) in built.items()}
    names = list(built)
    order = names + names[1:] + names[:1]       # as is first and last
    for name in order:
        use_library(built[name][0])
        if "max_abs_err" not in rows[name]:
            rows[name]["max_abs_err"] = check_dq(gen)
        rows[name]["ms"].append(timer(lambda: fa.flash_dq(*args)))
    for row in rows.values():
        print(json.dumps(row), flush=True)
    use_library(built["as_is"][0])
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    fwd = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True))
    print(json.dumps({
        "card": smi, "shape": dict(SHAPE, causal=True),
        "flash_dkv_ms": timer(lambda: fa.flash_dkv(*args)),
        "sdpa_bwd_ms": timer(sdpa_fwd_bwd) - fwd}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
