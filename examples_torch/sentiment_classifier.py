"""Sentiment classifier on the port: embedding → mean-pool → 2-layer MLP
→ binary cross entropy, trained under ``PartitionedPS`` (the vocab-sized
embedding is what the variable partitioner is for).  Synthetic separable
data stands in for IMDB.

Twin of ``examples/sentiment_classifier.py``: the same numpy draws, so
the same initial weights and batches.

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/sentiment_classifier.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv=None, params=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)
    if args.steps < 1:
        p.error("--steps must be >= 1")

    from autodist_tpu_torch import AutoDist, optim
    from autodist_tpu_torch.strategy import PartitionedPS

    vocab, emb_dim, hidden, seq = 10000, 16, 16, 20
    rng = np.random.RandomState(0)
    drawn = {
        "emb": rng.rand(vocab, emb_dim).astype(np.float32),
        "w1": (rng.rand(emb_dim, hidden) * 0.1).astype(np.float32),
        "b1": np.zeros((hidden,), np.float32),
        "w2": (rng.rand(hidden, 1) * 0.1).astype(np.float32),
        "b2": np.zeros((1,), np.float32),
    }
    if params is None:
        params = {k: torch.from_numpy(v) for k, v in drawn.items()}
    # Planted signal: each token leans +1/-1; a document's label is the
    # sign of its mean leaning.  Borderline documents (|mean| small) are
    # resampled away so the task is cleanly separable.
    w_tok = np.where(rng.rand(vocab) < 0.5, -1.0, 1.0).astype(np.float32)

    def make_batch(n):
        rows = []
        while len(rows) < n:
            x = rng.randint(0, vocab, (4 * n, seq)).astype(np.int32)
            score = w_tok[x].mean(axis=1)
            keep = np.abs(score) >= 0.3
            rows.extend(zip(x[keep], (score[keep] > 0)))
        x = np.stack([r[0] for r in rows[:n]])
        y = np.array([r[1] for r in rows[:n]], np.float32)
        return {"x": x, "y": y}

    def loss_fn(p, batch):
        h = p["emb"][batch["x"].long()].mean(dim=1)
        h = torch.relu(h @ p["w1"] + p["b1"])
        logits = (h @ p["w2"] + p["b2"])[:, 0]
        y = batch["y"]
        return torch.mean(torch.clamp(logits, min=0) - logits * y
                          + torch.log1p(torch.exp(-torch.abs(logits))))

    ad = AutoDist(strategy_builder=PartitionedPS(), device=args.device)
    with ad.scope():
        ad.capture(params=params, optimizer=optim.adam(1e-2),
                   loss_fn=loss_fn, sparse_vars=("emb",))
    sess = ad.create_distributed_session()
    for step in range(args.steps):
        out = sess.run(make_batch(args.batch_size))
        if step % 20 == 0:
            print(f"step {step:3d} loss {float(out['loss']):.4f}")
    final = float(out["loss"])
    print(f"final loss {final:.4f}")
    assert final < 0.45, final   # well below chance (~0.69)
    return final


if __name__ == "__main__":
    main()
