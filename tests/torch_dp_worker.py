"""One rank of a data-parallel run of the port's AutoDist facade on gloo CPU
ranks (spawned by ``tests/test_torch_training.py`` and
``tests/test_torch_zero1.py``).

    python tests/torch_dp_worker.py RANK WORLD PORT OUT.npz [zero1 [STATE]]

Trains a tiny ``transformer_lm`` for 3 steps on the same global batch of 8
rows, then writes the losses, the final parameters and the bucket count
to ``OUT.npz``.  The default strategy is ``AllReduce()`` with
``adam(1e-2)``.  ``zero1`` trains with ``Zero1(4096)``, ``fusable_adam(1e-2)``
and ``numerics={"clip_norm": 1.0}``, and also writes the global norms,
this rank's ZeRO-1 shard sizes and the logical state ``export_state``
gives; with ``STATE`` (a ``torch.save`` file of ``{"params", "opt_state",
"sync_state", "step"}`` per rank, keyed by rank) it then imports that
state into a fresh session and writes the losses of 2 more steps.
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
from autodist_tpu_torch.ops.fused_kernels import fusable_adam  # noqa: E402
from autodist_tpu_torch.strategy import AllReduce, Zero1  # noqa: E402

CFG = dict(vocab_size=97, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
           max_len=16)
STEPS = 3
CLIP = 1.0
#: the ZeRO-1 bucket cap of the ``zero1`` run: small, so the tiny model
#: spreads over several buckets
ZERO1_BUCKET_BYTES = 1 << 12


def session(strategy="allreduce", device="cpu"):
    """The facade's session for ``strategy`` in this process, and the
    model's fixed global batch."""
    torch.manual_seed(0)
    spec = transformer_lm(**CFG)
    zero1 = strategy == "zero1"
    ad = AutoDist(strategy_builder=Zero1(ZERO1_BUCKET_BYTES) if zero1
                  else AllReduce(), device=device)
    with ad.scope():
        ad.capture(params=spec.init(0, device=device),
                   optimizer=fusable_adam(1e-2) if zero1
                   else optim.adam(1e-2),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   numerics={"clip_norm": CLIP} if zero1 else None)
    return ad.create_distributed_session(), spec.sample_batch(8, seed=1)


def train(strategy="allreduce", device="cpu"):
    """Losses, final parameters and the session of the facade run."""
    sess, batch = session(strategy, device)
    losses = [float(sess.run(batch)["loss"]) for _ in range(STEPS)]
    return losses, dict(flatten(sess.params)), sess


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    strategy = sys.argv[5] if len(sys.argv) > 5 else "allreduce"
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        sess, batch = session(strategy)
        results = [sess.run(batch) for _ in range(STEPS)]
        data_axis, buckets = sess.data_axis_size, len(sess._step.buckets)
        trained = {f"p:{k}": v for k, v in flatten(sess.params)}
        extra = {}
        if strategy == "zero1":
            _, exported = sess.export_state()
            z = sess.opt_state["zero1"]
            extra = {"norms": np.array([float(r["grad_health"].global_norm)
                                        for r in results]),
                     **{f"shard:{k}": v.numel() for k, v in z["mu"].items()},
                     **{f"full_{m}:{k}": v.numpy()
                        for m in ("mu", "nu")
                        for k, v in exported["zero1"][m].items()}}
            if len(sys.argv) > 6:
                state = torch.load(sys.argv[6])[rank]
                sess, batch = session(strategy)
                sess.import_state(state["params"], state["opt_state"],
                                  step=state["step"],
                                  sync_state=state["sync_state"])
                extra["resumed"] = np.array(
                    [float(sess.run(batch)["loss"]) for _ in range(2)])
                extra.update({f"rp:{k}": v for k, v in
                              flatten(sess.params)})
        np.savez(out, losses=np.array([float(r["loss"]) for r in results]),
                 data_axis=data_axis, buckets=buckets, **trained, **extra)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
