#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``autodist_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device and build: the card, ``nvidia-smi``'s name and power limit, and
   the seconds to build every CUDA kernel from ``autodist_tpu_torch/csrc``;
2. kernel vs plain: each kernel at the shapes the serving path gives it,
   held against its plain PyTorch version, with its median device time
   over 50 launches (CUDA events, L2 evicted between launches, host
   launch overhead excluded), the plain version's time, one PyTorch
   library call's time and the least time the card could take (bytes
   over 3.35 TB/s, or f32 operations over 67 TFLOP/s, whichever is
   larger);
3. the slice at full width: ``transformer_lm()`` at its defaults (12
   layers, 12 heads x 64, vocab 32128, random weights from seed 0) served
   by ``serve(..., paged=True)`` over real HTTP after one warm-up pass of
   the same prompts; every answer must equal the port's plain generator
   token for token, and the paged-attention kernel must have been called
   12 times per decode tick (once per layer);
4. the slice in int8: the same weights quantized, a ``PagedDecodeEngine``
   run (after the same warm-up), token-exact against the generator on the
   int8 tree, with the int8 matmul kernel called 73 times per decode
   tick and per prefill dispatch.

Then one JSON line with every kernel's numbers (``launches`` counts the
wrapper's calls that launched its C entry point on the serving path; each
such call issues one kernel, or two where the work is split and then
merged), the ``nvidia-smi`` line, and last ``{"ok": true, "device":
{...}}``.  Any failed check raises and the exit code is not 0; without a
CUDA device, or without the package beside this script, it exits 2 and
prints no result.
"""
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

SEED = 0
H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores
K9_SOURCE = "autodist_tpu_torch/csrc/paged_attention.cu"
K9_REPLACES = "autodist_tpu/ops/fused_kernels.py:624"
K10_SOURCE = "autodist_tpu_torch/csrc/int8_matmul.cu"
K10_REPLACES = "autodist_tpu/ops/quant.py:74"
SERVE_GEOM = dict(slots=8, window=1024, block_size=32, chunk=16,
                  prefill_chunk=256)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median device time per call, with CUDA events.  Before each call
    the L2 cache (50 MB) is evicted by writing a 256 MB buffer, since the
    serving path reads each layer's weights and pool cold, and the card
    is held in a spin (``torch.cuda._sleep``) while the host enqueues the
    call, so the time is the card's and not the host's launch overhead."""

    SLEEP_CYCLES = 5_000_000     # ~2.5 ms at the H100's boost clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, iters: int = 50, warmup: int = 5) -> float:
        torch = self.torch
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


def phase_kernels(torch, timer):
    import torch.nn.functional as F
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")

    # --- K9: decode shape, engine-default pool -------------------------
    b, h, dh, bs, maxb = 8, 12, 64, 32, 32
    nb = b * maxb + maxb + 1
    q = torch.randn(b, h, dh, generator=gen).to(dev)
    kc = torch.randn(nb, bs, h, dh, generator=gen).to(dev)
    vc = torch.randn(nb, bs, h, dh, generator=gen).to(dev)
    bt = torch.randint(1, nb, (b, maxb), generator=gen).to(dev, torch.int32)
    w = maxb * bs
    rel_specs = {"first": [0] * b, "mid_block": [15] * b,
                 "block_edge": [31, 32, 63, 64, 95, 96, 127, 128],
                 "full": [w - 1] * b,
                 "mixed": [0, 15, 31, 32, 500, 700, 1000, w - 1]}
    k9_err = 0.0
    for name, rel_list in rel_specs.items():
        rel = torch.tensor(rel_list, dtype=torch.int32, device=dev)
        out = fk.paged_attention(q, kc, vc, bt, rel)
        ref = fk.paged_attention_reference(q, kc, vc, bt, rel)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5,
                                   msg=f"K9 rel={name}")
        k9_err = max(k9_err, (out - ref).abs().max().item())
    rel = torch.full((b,), w - 1, dtype=torch.int32, device=dev)
    live = int((rel.long() + 1).sum())
    nbytes = (live * h * dh * 2 * 4 + 2 * b * h * dh * 4
              + b * maxb * 4 + b * 4)
    k9_bound, k9_by = bound_ms(nbytes, 4.0 * live * h * dh)
    kb = kc[bt.long()].reshape(b, w, h, dh).permute(0, 2, 1, 3).contiguous()
    vb = vc[bt.long()].reshape(b, w, h, dh).permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(w, device=dev)[None, :] <= rel[:, None].long())
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    k9 = {
        "name": "paged_attention", "route": "cuda", "source": K9_SOURCE,
        "replaces": K9_REPLACES,
        "shape": dict(B=b, H=h, Dh=dh, BS=bs, MAXB=maxb, rel=w - 1),
        "max_abs_err": k9_err,
        "ms": timer(lambda: fk.paged_attention(q, kc, vc, bt, rel)),
        "plain_ms": timer(
            lambda: fk.paged_attention_reference(q, kc, vc, bt, rel)),
        "bound_ms": k9_bound, "bound_by": k9_by,
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            q4, kb, vb, attn_mask=mask)),
        "library_call": "F.scaled_dot_product_attention on the gathered "
                        "window (gather not timed)",
    }
    emit({"phase": "kernel", **k9})

    # --- K10: every (M, K, N) the serving path gives it -----------------
    k10_rows = []
    for m in (8, 512):
        for k, n in ((768, 768), (768, 3072), (3072, 768), (768, 32128)):
            # the model's scales: unit-variance activations after
            # LayerNorm, lecun-normal weights (std 1/sqrt(K))
            x = torch.randn(m, k, generator=gen).to(dev)
            wq = quant.quantize_weight(
                (torch.randn(k, n, generator=gen) / k ** 0.5).to(dev))
            wdeq = wq.q.float() * wq.scale
            out = quant.int8_matmul(x, wq)
            ref = quant.int8_matmul_reference(x, wq)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4,
                                       msg=f"K10 M={m} K={k} N={n}")
            nbytes = k * n + 4 * (m * k + n + m * n)
            bnd, by = bound_ms(nbytes, 2.0 * m * k * n)
            row = {"M": m, "K": k, "N": n,
                   "max_abs_err": (out - ref).abs().max().item(),
                   "ms": timer(lambda: quant.int8_matmul(x, wq)),
                   "plain_ms": timer(
                       lambda: quant.int8_matmul_reference(x, wq)),
                   "bound_ms": bnd, "bound_by": by,
                   "library_ms": timer(lambda: torch.matmul(x, wdeq))}
            emit({"phase": "kernel", "name": "int8_matmul", **row})
            k10_rows.append(row)
    head = next(r for r in k10_rows if (r["M"], r["N"]) == (8, 32128))
    k10 = {
        "name": "int8_matmul", "route": "cuda", "source": K10_SOURCE,
        "replaces": K10_REPLACES,
        "shape": {k: head[k] for k in ("M", "K", "N")},
        "max_abs_err": max(r["max_abs_err"] for r in k10_rows),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        "library_call": "torch.matmul against the pre-dequantized weight",
    }
    return k9, k10


def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        if body.get("stream"):
            events = [json.loads(line[6:]) for line in
                      resp.read().decode().splitlines()
                      if line.startswith("data: ")]
            final = events[-1]
            if not final.get("done") or "tokens" not in final:
                raise RuntimeError(f"stream ended without a result: {final}")
            return final, len(events)
        return json.loads(resp.read()), 1


def _check_exact(torch, gen, params, prompt, n, got, label):
    """``got`` must equal the plain generator's greedy output; on a
    mismatch report the first differing position and the top-2 logit gap
    there."""
    want = gen(params, prompt[None, :], n)[0].cpu().numpy()
    got = np.asarray(got)
    if got.shape == want.shape and np.array_equal(got, want):
        return
    _, logits = gen.with_logits(params, prompt[None, :], n)
    diff = np.nonzero(got[:want.size] != want[:got.size])[0]
    pos = int(diff[0]) if diff.size else min(got.size, want.size)
    top2 = torch.topk(logits[pos - 1, 0].float(), 2).values.tolist()
    raise AssertionError(
        f"{label}: output differs from the generator at position {pos} "
        f"(engine {got[pos] if pos < got.size else None}, generator "
        f"{want[pos] if pos < want.size else None}; top-2 logit gap there "
        f"{top2[0] - top2[1]:.3e})")


def _rates(engine):
    dec = [e for e in engine.timeline if e[0] == "decode"]
    pre = [e for e in engine.timeline if e[0] == "prefill"]
    dec_s = sum(e[3] for e in dec)
    pre_s = sum(e[3] for e in pre)
    return {
        "decode_tokens_per_s": sum(e[2] for e in dec) / dec_s,
        "ms_per_decode_tick": statistics.median(
            e[3] / e[1] * 1e3 for e in dec),
        "prefill_tokens_per_s": sum(e[2] for e in pre) / pre_s,
        "decode_ticks": sum(e[1] for e in dec),
        "decode_dispatches": len(dec), "prefill_dispatches": len(pre),
    }


def _warm_up(spec, params, prompts, device, geom):
    """One pass of a phase's prompts (2 new tokens each) through a
    throwaway engine, so first-call costs (CUDA module loading, GEMM
    heuristics per shape) stay out of the measured run."""
    from autodist_tpu_torch.serving import PagedDecodeEngine

    eng = PagedDecodeEngine(spec, params, device=device, **geom)
    for prompt in prompts:
        eng.submit(prompt, 2)
    eng.run()


def phase_serve(torch, spec, params, device="cuda", geom=SERVE_GEOM):
    from autodist_tpu_torch.models.generate import make_generator
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.ops import quant
    from autodist_tpu_torch.serving import serve

    vocab = spec.config["vocab_size"]
    rng = np.random.RandomState(SEED + 1)
    shared = rng.randint(0, vocab, 64).astype(np.int32)
    first = (np.concatenate([shared, rng.randint(0, vocab, 16)]), 48, False)
    second = (np.concatenate([shared, rng.randint(0, vocab, 30)]), 40, False)
    rest = [(rng.randint(0, vocab, p), n, stream) for p, n, stream in
            ((700, 128, False), (16, 64, True), (300, 96, False),
             (40, 32, False), (500, 100, False))]
    requests = [first, second] + [(p.astype(np.int32), n, s)
                                  for p, n, s in rest]

    _warm_up(spec, params, [r[0] for r in requests], device, geom)
    fk.paged_attention.calls = 0
    quant.int8_matmul.calls = 0
    srv = serve(spec, params, paged=True, device=device, host="127.0.0.1",
                port=0, **geom)
    try:
        url = "http://%s:%d" % srv.address
        answers = [None] * len(requests)
        sse_events = 0

        def call(i):
            nonlocal sse_events
            prompt, n, stream = requests[i]
            answers[i], ev = _post(url + "/v1/completions", {
                "prompt_tokens": [int(t) for t in prompt],
                "max_new_tokens": n, "stream": stream})
            sse_events += ev if stream else 0

        t0 = time.perf_counter()
        call(0)                   # warms the prefix trie
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(1, len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(a is None for a in answers):
            raise RuntimeError("a request got no answer")
        with urllib.request.urlopen(url + "/v1/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
        k9_calls = fk.paged_attention.calls
        k10_calls = quant.int8_matmul.calls
    finally:
        srv.close()
    eng = srv.engine
    eng.assert_no_leaks()
    ticks = eng.stats.ticks
    if k9_calls <= 0 or k9_calls != spec.config["num_layers"] * ticks:
        raise AssertionError(f"paged_attention called {k9_calls} times "
                             f"for {ticks} decode ticks")
    if stats["trie_lookup_hits"] < 1 or eng.stats.cached_prompt_tokens < 64:
        raise AssertionError(f"the shared-prefix request missed the trie: "
                             f"{stats}")
    if sse_events < 2:
        raise AssertionError("the streamed request sent no SSE events")
    gen = make_generator(spec, device=device)
    for i, ((prompt, n, _), ans) in enumerate(zip(requests, answers)):
        _check_exact(torch, gen, params, prompt, n, ans["tokens"],
                     f"HTTP request {i}")
    return {"requests": len(requests), "wall_s": wall,
            "paged_attention_calls": k9_calls,
            "int8_matmul_calls": k10_calls,
            "prefix_hit_tokens": eng.stats.cached_prompt_tokens,
            "prefill_chunks": eng.stats.prefill_chunks,
            "generated_tokens": eng.stats.generated_tokens,
            "sse_events": sse_events, **_rates(eng)}


def phase_int8(torch, spec, params, device="cuda", geom=SERVE_GEOM):
    from autodist_tpu_torch.models.generate import make_generator
    from autodist_tpu_torch.models.quantize import quantize_lm_params
    from autodist_tpu_torch.ops import fused_kernels as fk
    from autodist_tpu_torch.ops import quant
    from autodist_tpu_torch.serving import PagedDecodeEngine

    qparams = quantize_lm_params(params)
    vocab = spec.config["vocab_size"]
    rng = np.random.RandomState(SEED + 2)
    requests = [(rng.randint(0, vocab, p).astype(np.int32), n)
                for p, n in ((32, 64), (300, 64), (100, 48), (600, 32))]
    _warm_up(spec, qparams, [r[0] for r in requests], device, geom)
    eng = PagedDecodeEngine(spec, qparams, device=device, **geom)
    fk.paged_attention.calls = 0
    quant.int8_matmul.calls = 0
    ids = [eng.submit(p, n) for p, n in requests]
    results = eng.run()
    k9_calls = fk.paged_attention.calls
    k10_calls = quant.int8_matmul.calls
    eng.assert_no_leaks()
    # q/k/v/out + wi/wo per layer, plus the tied head, per decode tick and
    # per prefill dispatch
    per_forward = 6 * spec.config["num_layers"] + 1
    dispatches = eng.stats.ticks + eng.stats.prefill_dispatches
    if k10_calls <= 0 or k10_calls != per_forward * dispatches:
        raise AssertionError(f"int8_matmul called {k10_calls} times "
                             f"for {dispatches} decode ticks and prefill "
                             f"dispatches ({per_forward} each)")
    if k9_calls != spec.config["num_layers"] * eng.stats.ticks:
        raise AssertionError(f"paged_attention called {k9_calls} times "
                             f"for {eng.stats.ticks} decode ticks")
    gen = make_generator(spec, device=device)
    for rid, (prompt, n) in zip(ids, requests):
        _check_exact(torch, gen, qparams, prompt, n, results[rid],
                     f"int8 request {rid}")
    return {"requests": len(requests),
            "paged_attention_calls": k9_calls,
            "int8_matmul_calls": k10_calls,
            "int8_matmul_calls_per_decode_tick": per_forward,
            "generated_tokens": eng.stats.generated_tokens,
            **_rates(eng)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from autodist_tpu_torch.models.transformer_lm import transformer_lm
        from autodist_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "device", "device": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0})

    timer = Timer(torch)
    k9, k10 = phase_kernels(torch, timer)
    del timer

    spec = transformer_lm()          # the repo's defaults, float32
    t0 = time.perf_counter()
    params = spec.init(SEED, device="cuda")
    init_s = time.perf_counter() - t0
    serve_out = phase_serve(torch, spec, params)
    emit({"phase": "serve", "init_s": init_s, **serve_out})
    k9["launches"] = serve_out["paged_attention_calls"]

    int8_out = phase_int8(torch, spec, params)
    emit({"phase": "int8", **int8_out})
    k10["launches"] = int8_out["int8_matmul_calls"]

    emit({"kernels": [k9, k10], "card": smi,
          "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
