"""Pipelined LM trained through the 1F1B schedule (hand-built backward),
on the port.

Twin of ``examples/pipeline_1f1b.py``: two specs of the same model train
side by side, GPipe (autograd through the tick loop, O(M) stashed
activations) and 1F1B (``autodist_tpu_torch/parallel/pipeline_1f1b.py``,
the backward interleaved into the ring, O(S·V) stashed activations,
plugged in through ``capture(grad_fn=...)``); their losses match step for
step.  ``--virtual-stages V`` selects the interleaved layout for both
schedules.  On the cards each stage's attention runs the flash kernels
K1–K3.

The mesh spans the ``torch.distributed`` world: ``--pipe`` ×
``--data-shards`` ranks, started by a launcher (``torchrun
--nproc-per-node N``) or by a caller that made the process group.  Run
(the CUDA cards; ``--device cpu`` and gloo on the CPU):

    torchrun --nproc-per-node 4 examples_torch/pipeline_1f1b.py \\
        --pipe 2 --data-shards 2 --virtual-stages 2

(``--num-layers`` must divide into pipe x virtual-stages chunks.)
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples_torch.long_context import _join_world  # noqa: E402


def main(argv=None, params=None):
    from autodist_tpu_torch import AutoDist, optim
    from autodist_tpu_torch.autodist import \
        _reset_default_autodist_for_testing
    from autodist_tpu_torch.mesh import build_mesh
    from autodist_tpu_torch.models.pipelined_lm import \
        pipelined_transformer_lm
    from autodist_tpu_torch.strategy import PSLoadBalancing

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pipe", type=int, default=4)
    p.add_argument("--data-shards", type=int, default=2)
    p.add_argument("--virtual-stages", type=int, default=1)
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)

    _join_world(args.device)
    axes = {"pipe": args.pipe, "data": args.data_shards}
    mesh = build_mesh(axes, device=args.device)
    if args.num_layers % (args.pipe * args.virtual_stages):
        p.error("--num-layers must divide into pipe x virtual-stages "
                "chunks")
    kw = dict(vocab_size=2048, num_layers=args.num_layers, num_heads=4,
              head_dim=16, d_ff=64, max_len=args.seq_len,
              seq_len=args.seq_len,
              num_virtual_stages=args.virtual_stages)

    losses = {}
    for sched in ("1f1b", "gpipe"):
        # DEMO-ONLY: a real training script builds ONE AutoDist per
        # process.  This side-by-side comparison needs two, so it uses the
        # testing reset (requires AUTODIST_IS_TESTING=True).
        os.environ.setdefault("AUTODIST_IS_TESTING", "True")
        _reset_default_autodist_for_testing()
        spec = pipelined_transformer_lm(mesh, schedule=sched, **kw)
        init = spec.init(0, device=mesh.device) if params is None \
            else params
        ad = AutoDist(strategy_builder=PSLoadBalancing(), mesh_axes=axes,
                      device=args.device)
        with ad.scope():
            ad.capture(params=init, optimizer=optim.adam(1e-2),
                       loss_fn=spec.loss_fn, grad_fn=spec.grad_fn,
                       sparse_vars=spec.sparse_vars,
                       pipeline_vars=spec.pipeline_vars)
        sess = ad.create_distributed_session(mesh=mesh)
        batch = spec.sample_batch(args.batch_size)
        losses[sched] = [float(sess.run(batch)["loss"])
                         for _ in range(args.steps)]
        print(f"{sched:>6}: " + " ".join(f"{v:.4f}" for v in losses[sched]))

    drift = max(abs(a - b) / abs(a)
                for a, b in zip(losses["1f1b"], losses["gpipe"]))
    print(f"max relative drift 1F1B vs GPipe: {drift:.2e}")
    assert drift < 1e-3
    return losses


if __name__ == "__main__":
    main()
