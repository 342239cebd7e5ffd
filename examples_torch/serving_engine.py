"""Continuous-batching serving demo on the port (``serving/engine.py``).

Twin of ``examples/serving_engine.py``: a mixed-length request stream
through the slot engine; finished requests are harvested and queued ones
admitted (with parallel prompt prefill) without stopping the batch.
Dense attention, as the JAX script passes it.

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/serving_engine.py
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main(argv=None, params=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--window", type=int, default=96)
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)

    from autodist_tpu_torch.models import make_generator, transformer_lm
    from autodist_tpu_torch.models.transformer import dense_attention
    from autodist_tpu_torch.serving import DecodeEngine

    vocab, eos = 64, 2
    spec = transformer_lm(vocab_size=vocab, num_layers=2, num_heads=2,
                          head_dim=16, d_ff=64, max_len=args.window,
                          seq_len=32, attn_fn=dense_attention)
    if params is None:
        params = spec.init(0, device=args.device)

    rng = np.random.RandomState(0)
    eng = DecodeEngine(spec, params, slots=args.slots,
                       window=args.window, chunk=8, eos_id=eos,
                       device=args.device)
    reqs = {}
    for _ in range(args.requests):
        prompt = rng.randint(0, vocab, rng.randint(2, 9)).astype(np.int32)
        n = int(rng.randint(4, 24))
        reqs[eng.submit(prompt, n)] = (prompt, n)
    print(f"submitted {len(reqs)} requests "
          f"(P=2..8, N=4..23) into {args.slots} slots")

    t0 = time.perf_counter()
    results = eng.run()
    dt = time.perf_counter() - t0
    s = eng.stats
    print(f"decoded {s.generated_tokens} tokens in {dt:.2f}s "
          f"({s.generated_tokens / dt:.0f} tok/s aggregate)")
    print(f"ticks={s.ticks} chunks={s.chunks} "
          f"slot_utilization={s.slot_utilization:.2f} "
          f"prefill_admissions={s.prefill_admissions}")

    # Spot-check three results against the per-request oracle decode.
    gen = make_generator(spec, device=args.device)
    for rid in list(results)[:3]:
        prompt, n = reqs[rid]
        want = gen(params, prompt[None, :], n, eos_id=eos)[0].cpu().numpy()
        got = results[rid]
        assert np.array_equal(got, want[:got.size]), rid
        print(f"  req {rid}: P={prompt.size} -> {got.size - prompt.size} "
              f"tokens (oracle-exact)")
    return s.generated_tokens / dt


if __name__ == "__main__":
    main()
