"""Long-context training: ring attention over the ``seq`` mesh axis, on
the port.

Twin of ``examples/long_context.py``: a causal LM whose sequences are cut
into chunks over the ``seq`` axis — K/V blocks travel around the seq
group's ring (``autodist_tpu_torch.parallel.make_ring_attention``) while
each rank's block runs the flash kernels K1–K3 (head dim 32) — so the
longest context grows with the ranks at constant memory per rank.  The
optimizer is ``adamw`` unclipped, as in the JAX script.

The mesh spans the ``torch.distributed`` world: ``--data-shards`` ×
``--seq-shards`` ranks, started by a launcher (``torchrun
--nproc-per-node N``: the ranks find each other through its
environment) or by a caller that made the process group.  Run (the CUDA
cards; ``--device cpu`` and gloo on the CPU):

    torchrun --nproc-per-node 4 examples_torch/long_context.py \\
        --data-shards 1 --seq-shards 4
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples_torch.benchmark.common import (benchmark_args,  # noqa: E402
                                             init_params, make_autodist,
                                             run_selected_benchmark)


def _join_world(device) -> None:
    """Join the launcher's process group (``WORLD_SIZE`` > 1 in the
    environment) unless the caller already made one: NCCL on the cards,
    gloo on the CPU."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return
    cpu = device == "cpu" or not torch.cuda.is_available()
    dist.init_process_group("gloo" if cpu else "nccl")


def main(argv=None, params=None):
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.mesh import build_mesh
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.parallel import make_ring_attention

    p = benchmark_args("long-context LM (sequence parallelism)")
    p.set_defaults(strategy="PartitionedPS", batch_size=4)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--seq-shards", type=int, default=4)
    p.add_argument("--data-shards", type=int, default=2)
    args = p.parse_args(argv)

    _join_world(args.device)
    axes = {"data": args.data_shards, "seq": args.seq_shards}
    mesh = build_mesh(axes, device=args.device)
    spec = transformer_lm(
        vocab_size=2048, num_layers=2, num_heads=4, head_dim=32, d_ff=512,
        max_len=args.seq_len, seq_len=args.seq_len,
        attn_fn=make_ring_attention(mesh))
    params = init_params(spec, params, mesh.device)

    ad = make_autodist(args, mesh_axes=axes)
    with ad.scope():
        ad.capture(params=params, optimizer=optim.adamw(args.lr),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars)
    sess = ad.create_distributed_session(mesh=mesh)
    return run_selected_benchmark(
        spec, sess, args, unit="tokens",
        items_per_batch=args.batch_size * args.seq_len)


if __name__ == "__main__":
    main()
