"""Pipelined MoE LM showcase: pipeline × expert × data parallelism, on the
port.

Twin of ``examples/moe_pipeline.py``: the stage-stacked MoE transformer,
its layer stack cut over ``pipe`` (the microbatches' ring), its expert
weights over ``expert`` (gathered for each stage's MoE FFN inside the
step), the batch over ``data``.

The mesh spans the ``torch.distributed`` world: ``--pipe`` ×
``--expert-shards`` × ``--data-shards`` ranks, started by a launcher
(``torchrun --nproc-per-node N``) or by a caller that made the process
group.  Run (the CUDA cards; ``--device cpu`` and gloo on the CPU):

    torchrun --nproc-per-node 8 examples_torch/moe_pipeline.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples_torch.benchmark.common import (benchmark_args,  # noqa: E402
                                             init_params, make_autodist,
                                             run_selected_benchmark)
from examples_torch.long_context import _join_world  # noqa: E402


def main(argv=None, params=None):
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.mesh import build_mesh
    from autodist_tpu_torch.models.pipelined_moe_lm import \
        pipelined_moe_transformer_lm

    p = benchmark_args("pipelined MoE LM (pp x ep x dp)")
    p.set_defaults(strategy="PSLoadBalancing", batch_size=8)
    p.add_argument("--pipe", type=int, default=2)
    p.add_argument("--expert-shards", type=int, default=2)
    p.add_argument("--data-shards", type=int, default=2)
    p.add_argument("--experts", type=int, default=4)
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--remat", action="store_true",
                   help="rematerialize stage internals in backward "
                        "(cuts stashed activation memory)")
    args = p.parse_args(argv)

    _join_world(args.device)
    axes = {"pipe": args.pipe, "expert": args.expert_shards,
            "data": args.data_shards}
    mesh = build_mesh(axes, device=args.device)
    spec = pipelined_moe_transformer_lm(
        mesh, vocab_size=2048, num_layers=args.num_layers, num_heads=4,
        head_dim=32, d_ff=512, num_experts=args.experts,
        max_len=args.seq_len, seq_len=args.seq_len, remat=args.remat)
    params = init_params(spec, params, mesh.device)

    ad = make_autodist(args, mesh_axes=axes)
    with ad.scope():
        ad.capture(params=params, optimizer=optim.adamw(args.lr),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   pipeline_vars=spec.pipeline_vars,
                   expert_vars=spec.expert_vars)
    sess = ad.create_distributed_session(mesh=mesh)
    return run_selected_benchmark(
        spec, sess, args, unit="tokens",
        items_per_batch=args.batch_size * args.seq_len)


if __name__ == "__main__":
    main()
