"""One rank of a data-parallel run of the port's AutoDist facade on gloo CPU
ranks (spawned by ``tests/test_torch_training.py``).

    python tests/torch_dp_worker.py RANK WORLD PORT OUT.npz

Trains a tiny ``transformer_lm`` with ``AllReduce()`` and ``adam(1e-2)``
for 3 steps on the same global batch of 8 rows, then writes the losses,
the final parameters and the bucket count to ``OUT.npz``.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from autodist_tpu_torch import optim  # noqa: E402
from autodist_tpu_torch.autodist import AutoDist  # noqa: E402
from autodist_tpu_torch.graph_item import flatten  # noqa: E402
from autodist_tpu_torch.models.transformer_lm import \
    transformer_lm  # noqa: E402
from autodist_tpu_torch.strategy import AllReduce  # noqa: E402

CFG = dict(vocab_size=97, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
           max_len=16)
STEPS = 3


def train(device="cpu"):
    """Losses and final parameters of the facade run in this process."""
    torch.manual_seed(0)
    spec = transformer_lm(**CFG)
    params = spec.init(0, device=device)
    batch = spec.sample_batch(8, seed=1)
    ad = AutoDist(strategy_builder=AllReduce(), device=device)
    with ad.scope():
        ad.capture(params=params, optimizer=optim.adam(1e-2),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars)
    sess = ad.create_distributed_session()
    losses = [float(sess.run(batch)["loss"]) for _ in range(STEPS)]
    return losses, dict(flatten(sess.params)), sess


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        losses, params, sess = train()
        np.savez(out, losses=np.array(losses),
                 data_axis=sess.data_axis_size,
                 buckets=len(sess._step.buckets),
                 **{f"p:{k}": v for k, v in params.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
