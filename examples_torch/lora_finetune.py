"""LoRA finetuning demo on the port (``models/lora.py`` and the freeze
machinery).

Twin of ``examples/lora_finetune.py``: pretrains a small TransformerLM on
one distribution, then LoRA-finetunes it onto a shifted distribution with
the base frozen (optimizer state only for the adapters) and decodes from
the merged weights.  The adapters are drawn from a ``torch.Generator``
seeded as the JAX script seeds its key.

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/lora_finetune.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv=None, params=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rank", type=int, default=4)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.autodist import AutoDist, \
        _reset_default_autodist_for_testing
    from autodist_tpu_torch.graph_item import flatten, tree_map
    from autodist_tpu_torch.models import lora_setup, make_generator, \
        resolve_device, transformer_lm
    from autodist_tpu_torch.models.transformer import dense_attention
    from autodist_tpu_torch.strategy import AllReduce

    dev = resolve_device(args.device)
    spec = transformer_lm(vocab_size=97, num_layers=2, num_heads=2,
                          head_dim=8, d_ff=64, max_len=48, seq_len=16,
                          attn_fn=dense_attention)

    # -- pretrain (full-parameter) on "even tokens" sequences -------------
    rng = np.random.RandomState(0)

    def batch_of(parity, n=32):
        toks = rng.randint(0, 48, (n, 17)) * 2 + parity
        return {"tokens": toks[:, :16].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    if params is None:
        params = spec.init(0, device=dev)
    ad = AutoDist(strategy_builder=AllReduce(), device=dev)
    with ad.scope():
        ad.capture(params=params, optimizer=optim.adam(5e-3),
                   loss_fn=spec.loss_fn)
    sess = ad.create_distributed_session()
    for _ in range(args.steps):
        out = sess.run(batch_of(0))
    base = sess.params
    print(f"pretrain (even tokens): loss {float(out['loss']):.3f}")

    # -- LoRA-finetune onto "odd tokens" with the base frozen --------------
    _reset_default_autodist_for_testing()
    setup = lora_setup(tree_map(lambda x: torch.as_tensor(x).to(dev), base),
                       spec.loss_fn,
                       rng=torch.Generator(device=dev).manual_seed(1),
                       rank=args.rank,
                       targets=[("*/attn/out/*", 2), "*/attn/*",
                                "*/mlp/*"])
    n_base = sum(x.size for _, x in flatten(base))
    print(f"adapters: {setup.num_adapter_params:,} params "
          f"({100 * setup.num_adapter_params / n_base:.1f}% of base)")
    ad2 = AutoDist(strategy_builder=AllReduce(), device=dev)
    with ad2.scope():
        ad2.capture(**setup.capture_args, optimizer=optim.adam(5e-3))
    sess2 = ad2.create_distributed_session()
    l0 = float(sess2.run(batch_of(1))["loss"])
    for _ in range(args.steps):
        out = sess2.run(batch_of(1))
    l1 = float(out["loss"])
    print(f"finetune (odd tokens): loss {l0:.3f} -> {l1:.3f}")
    assert l1 < l0, "adapters did not learn"

    after = sess2.params
    drift = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for (_, a), (_, b) in zip(flatten(after["base"]),
                                          flatten(base)))
    print(f"base drift: {drift} (must be 0.0)")
    assert drift == 0.0

    merged = tree_map(lambda x: x.to(dev), setup.merge(after))
    gen = make_generator(spec, device=dev)
    prompt = np.asarray([[1, 3]], np.int32)
    toks = gen(merged, prompt, 8)[0].cpu().numpy()
    odd = sum(int(t) % 2 for t in toks[2:])
    print(f"merged decode after odd-token finetune: {toks.tolist()} "
          f"({odd}/8 odd)")
    print("lora_finetune demo OK")
    return l0, l1


if __name__ == "__main__":
    main()
