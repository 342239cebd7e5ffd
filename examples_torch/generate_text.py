"""Train a tiny LM through AutoDist on the port, then decode from it with
the KV-cache generator: the serving-side loop.

Twin of ``examples/generate_text.py`` (``Parallax``, dense attention, as
the JAX script passes it).

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/generate_text.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def _np(x):
    return x.detach().cpu().numpy()


def main(argv=None, params=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--new-tokens", type=int, default=12)
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)

    from autodist_tpu_torch import AutoDist, optim
    from autodist_tpu_torch.models import make_generator, transformer_lm
    from autodist_tpu_torch.models.transformer import dense_attention
    from autodist_tpu_torch.strategy import Parallax

    vocab = 64
    spec = transformer_lm(vocab_size=vocab, num_layers=2, num_heads=2,
                          head_dim=8, d_ff=64, max_len=48, seq_len=16,
                          attn_fn=dense_attention)
    if params is None:
        params = spec.init(0, device=args.device)

    # A learnable toy language: ascending token runs with wraparound.
    rng = np.random.RandomState(0)

    def make_batch(n=32):
        start = rng.randint(0, vocab, (n, 1))
        seq = (start + np.arange(16)[None, :]) % vocab
        return {"tokens": seq.astype(np.int32)}

    ad = AutoDist(strategy_builder=Parallax(), device=args.device)
    with ad.scope():
        ad.capture(params=params, optimizer=optim.adam(1e-2),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars)
    sess = ad.create_distributed_session()
    for i in range(args.steps):
        out = sess.run(make_batch())
        if i % 10 == 0:
            print(f"step {i:3d} loss {float(out['loss']):.4f}")

    # the logical tree on the device (a variable stored 1/N gathered)
    trained = sess.export_state()[0]
    gen = make_generator(spec, device=args.device)
    prompt = np.array([[5, 6, 7, 8], [40, 41, 42, 43]], np.int32)
    tokens = _np(gen(trained, prompt, args.new_tokens))
    for row in tokens:
        print("generated:", " ".join(map(str, row.tolist())))
    # The model should have learned to continue the ascending run.
    cont = tokens[:, 4:]
    expect = (tokens[:, 3:4] + 1 + np.arange(args.new_tokens)) % vocab
    acc = float((cont == expect).mean())
    print(f"ascending-run continuation accuracy: {acc:.2f}")
    assert acc > 0.9, acc

    # The rest of the serving surface on the same generator:
    beam_tokens, beam_lp = gen.beam_search(trained, prompt,
                                           args.new_tokens, num_beams=4)
    print("beam-4 suffix logprob:", [round(float(x), 3)
                                     for x in _np(beam_lp)])
    ll, ppl = gen.score(trained, tokens)
    print("self-scored perplexity of the generations:",
          [round(float(x), 3) for x in _np(ppl)])
    # a trained pattern-follower should be near-certain of its own output
    assert float(_np(ppl).mean()) < 2.0
    return acc


if __name__ == "__main__":
    main()
