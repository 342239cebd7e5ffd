"""End-to-end input pipeline: the native loader → fit → async checkpoints,
on the port.

Twin of ``examples/input_pipeline.py``: the prefetching ``DataLoader``
(``autodist_tpu_torch.runtime``; C++ threads shuffle, gather and cast the
features to bfloat16 on the host) feeds ``session.fit`` while an
``async_save`` Saver writes checkpoints behind training.  The optimizer
is ``adam(0.05)`` unclipped, as in the JAX script.

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/input_pipeline.py
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv=None, params=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--rows", type=int, default=4096)
    p.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "autodist_tpu_pipeline"))
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)

    from autodist_tpu_torch import AutoDist, TimeHistory, optim
    from autodist_tpu_torch.runtime import DataLoader, native_available
    from autodist_tpu_torch.strategy import PSLoadBalancing

    # synthetic regression data, float32 on the host; the loader casts the
    # features to bf16 while gathering (host threads, not the card's time)
    rng = np.random.RandomState(0)
    x = rng.randn(args.rows, 64).astype(np.float32)
    w = rng.randn(64, 8).astype(np.float32)
    y = (x @ w).astype(np.float32)
    loader = DataLoader({"x": x, "y": y}, batch_size=args.batch_size,
                        shuffle=True, to_bf16=["x"], num_threads=4,
                        prefetch_depth=2)

    if params is None:
        params = {"w": torch.zeros(64, 8), "b": torch.zeros(8)}

    def loss_fn(p, batch):
        pred = torch.as_tensor(batch["x"]).float() @ p["w"] + p["b"]
        return torch.mean((pred - torch.as_tensor(batch["y"])) ** 2)

    ad = AutoDist(strategy_builder=PSLoadBalancing(), device=args.device)
    with ad.scope():
        ad.capture(params=params, optimizer=optim.adam(0.05),
                   loss_fn=loss_fn)
    sess = ad.create_distributed_session()

    th = TimeHistory(items_per_step=args.batch_size)
    hist = sess.fit(loader, epochs=args.epochs, callbacks=[th],
                    log_every=20, checkpoint_dir=args.checkpoint_dir,
                    async_checkpoints=True)
    for e, rate in enumerate(th.items_per_sec):
        print(f"epoch {e}: {rate:,.0f} samples/sec, "
              f"loss {hist.history['epoch_loss'][e]:.5f}")
    print(f"final loss {hist.history['epoch_loss'][-1]:.6f} after "
          f"{hist.steps_run} steps; native loader {native_available()}; "
          f"checkpoints in {args.checkpoint_dir}")
    assert hist.history["epoch_loss"][-1] < hist.history["epoch_loss"][0]
    return th.items_per_sec[-1]


if __name__ == "__main__":
    main()
