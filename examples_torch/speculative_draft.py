"""Speculative decoding with a TRAINED draft model, on the port.

Twin of ``examples/speculative_draft.py``: train a target LM through the
framework, train a much smaller draft on the same data with a plain
loop, then decode speculatively: the draft proposes ``gamma`` tokens per
verify pass, the target accepts a measured fraction, and the output is
still token-exact target-greedy.  Dense attention, as the JAX script
passes it.

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/speculative_draft.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv=None, params=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--new-tokens", type=int, default=24)
    p.add_argument("--gamma", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)

    from autodist_tpu_torch import AutoDist, optim
    from autodist_tpu_torch.graph_item import flatten, tree_map
    from autodist_tpu_torch.models import make_generator, resolve_device, \
        transformer_lm
    from autodist_tpu_torch.models.speculative import \
        make_speculative_generator
    from autodist_tpu_torch.models.transformer import dense_attention
    from autodist_tpu_torch.strategy import Parallax

    dev = resolve_device(args.device)
    vocab, seq = 32, 24
    max_len = seq + args.new_tokens + args.gamma + 4
    # Task: x[t+1] = (3*x[t] + 7) mod V with 10% noise, learnable by both
    # models, so the trained draft tracks the target closely.
    rng = np.random.RandomState(0)

    def make_batch(n=64):
        s = np.zeros((n, seq), np.int64)
        s[:, 0] = rng.randint(0, vocab, n)
        for t in range(1, seq):
            s[:, t] = (3 * s[:, t - 1] + 7) % vocab
        noise = rng.random((n, seq)) < 0.10
        s[noise] = rng.randint(0, vocab, int(noise.sum()))
        return {"tokens": s.astype(np.int32)}

    target_spec = transformer_lm(
        vocab_size=vocab, num_layers=3, num_heads=4, head_dim=16,
        d_ff=128, max_len=max_len, seq_len=seq, attn_fn=dense_attention)
    draft_spec = transformer_lm(
        vocab_size=vocab, num_layers=1, num_heads=2, head_dim=8,
        d_ff=32, max_len=max_len, seq_len=seq, attn_fn=dense_attention)

    # Target: trained through the framework session path.
    t_params = target_spec.init(0, device=dev) if params is None \
        else params
    ad = AutoDist(strategy_builder=Parallax(), device=dev)
    with ad.scope():
        ad.capture(params=t_params, optimizer=optim.adam(3e-3),
                   loss_fn=target_spec.loss_fn,
                   sparse_vars=target_spec.sparse_vars)
    sess = ad.create_distributed_session()
    for i in range(args.steps):
        out = sess.run(make_batch())
        if i % 50 == 0:
            print(f"target step {i:3d} loss {float(out['loss']):.4f}")
    t_params = sess.export_state()[0]

    # Draft: a ~30x-smaller model trained on the same stream with a plain
    # loop (a draft is typically produced offline).
    d_params = tree_map(lambda x: x.requires_grad_(),
                        draft_spec.init(1, device=dev))
    opt = optim.adam(3e-3)
    opt_state = opt.init(d_params)
    names = [n for n, _ in flatten(d_params)]

    def draft_step(batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss = draft_spec.loss_fn(d_params, batch)
        leaves = dict(flatten(d_params))
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        with torch.no_grad():
            opt.step_(d_params, dict(zip(names, grads)), opt_state)
        return loss.detach()

    for i in range(args.steps):
        loss = draft_step(make_batch())
        if i % 50 == 0:
            print(f"draft  step {i:3d} loss {float(loss):.4f}")

    n_t = sum(x.numel() for _, x in flatten(t_params))
    n_d = sum(x.numel() for _, x in flatten(d_params))
    print(f"target params: {n_t:,}  draft params: {n_d:,} "
          f"({n_t / n_d:.1f}x smaller draft)")

    d_params = tree_map(lambda x: x.detach(), d_params)
    prompt = make_batch(4)["tokens"][:, :8]
    sg = make_speculative_generator(target_spec, draft_spec, device=dev)
    tokens, stats = sg(t_params, d_params, prompt, args.new_tokens,
                       args.gamma)
    # the per-row counters summed over the batch: the aggregate rate
    acc = float(stats["accepted"].sum()) / max(
        float(stats["proposed"].sum()), 1.0)
    iters = int(stats["iterations"])
    # The honest comparison is TARGET work: plain batched greedy decode
    # runs the target for new_tokens sequential ticks; speculation runs
    # it for `iters` batched verify passes (plus gamma cheap draft ticks
    # per pass).
    print(f"acceptance rate: {acc:.2f}  "
          f"(target: {args.new_tokens} sequential decode ticks -> "
          f"{iters} batched verify passes, + {args.gamma} draft ticks "
          f"per pass)")

    # The guarantee: speculative output IS target-greedy, token-exact.
    gen = make_generator(target_spec, device=dev)
    want = gen(t_params, prompt, args.new_tokens).cpu().numpy()
    np.testing.assert_array_equal(tokens.cpu().numpy(), want)
    print("speculative output == target greedy decode (token-exact)")

    # A trained draft on a learnable task should be accepted most of the
    # time: the number that makes speculation pay.
    assert acc > 0.5, f"trained-draft acceptance unexpectedly low: {acc}"
    return acc


if __name__ == "__main__":
    main()
