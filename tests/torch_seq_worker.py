"""One rank of a sequence-parallel run of the port on gloo CPU ranks
(spawned by ``tests/test_torch_sequence_parallel.py``).

    python tests/torch_seq_worker.py RANK WORLD INIT OUT.npz MODE IN.npz

(started by ``tests/torch_launch.py``; ``INIT`` is the group's init
method, a ``file://`` store).

``attn`` (``WORLD`` ranks on a ``{"seq": WORLD}`` mesh; ``IN``: global
``q``, ``k``, ``v`` ``[B, T, H, D]``): each of :data:`ATTN_IMPLS`, causal
and not, on this rank's chunk of q/k/v inside ``seq_chunk``, and the
backward of ``sum(out ** 2)``; writes this rank's chunk of the output and
of dq, dk, dv (the ring's and the all-to-all's backward bring every
rank's contribution home, so the chunks join to the global gradients).

``lm`` (4 ranks on ``{"data": 2, "seq": 2}``; ``IN``: the JAX weights
``p:<name>`` and the batch ``tokens``): the LM of :data:`LM_CFG` under
``AllReduce()`` and ``sgd(0.1)`` for 3 steps with each attention of
:data:`LM_ATTNS`, and under ``Zero1()`` with the ring; writes the losses,
the final parameters (``<attn>/p:<name>``), the mesh's axis facts and
whether a loss that is not sequence-parallel raised naming P10.

Each rank runs one intra-op thread.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_launch  # noqa: E402

from autodist_tpu_torch import optim  # noqa: E402
from autodist_tpu_torch.autodist import (  # noqa: E402
    AutoDist, _reset_default_autodist_for_testing)
from autodist_tpu_torch.const import P10  # noqa: E402
from autodist_tpu_torch.graph_item import flatten, unflatten  # noqa: E402
from autodist_tpu_torch.mesh import build_mesh, seq_chunk  # noqa: E402
from autodist_tpu_torch.models.transformer import \
    dense_attention  # noqa: E402
from autodist_tpu_torch.models.transformer_lm import \
    transformer_lm  # noqa: E402
from autodist_tpu_torch.ops.flash_attention import \
    flash_attention  # noqa: E402
from autodist_tpu_torch.parallel import (  # noqa: E402
    make_ring_attention, make_ulysses_attention)
from autodist_tpu_torch.strategy import AllReduce, Zero1  # noqa: E402

#: the attention functions the ``attn`` mode runs, by name
ATTN_IMPLS = {
    "ring_dense": lambda mesh: make_ring_attention(mesh, inner="dense"),
    "ring_flash": lambda mesh: make_ring_attention(mesh, inner="flash"),
    "ulysses_dense": lambda mesh: make_ulysses_attention(mesh,
                                                         inner="dense"),
    "ulysses_flash": lambda mesh: make_ulysses_attention(mesh,
                                                         inner="flash"),
}
#: the JAX end-to-end test's LM (``tests/test_sequence_parallel.py``)
LM_CFG = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=8,
              d_ff=64, max_len=32, seq_len=32)
LM_AXES = {"data": 2, "seq": 2}
LM_STEPS = 3
#: the LM runs: name -> (attention factory, strategy builder)
LM_ATTNS = {
    "ring": (lambda mesh: make_ring_attention(mesh), AllReduce),
    "ring_flash": (lambda mesh: make_ring_attention(mesh, inner="flash"),
                   AllReduce),
    "ulysses": (lambda mesh: make_ulysses_attention(mesh), AllReduce),
    "dense": (lambda mesh: dense_attention, AllReduce),
    "flash": (lambda mesh: flash_attention, AllReduce),
    "ring_zero1": (lambda mesh: make_ring_attention(mesh), Zero1),
}


def attn_main(data, world, rank):
    mesh = build_mesh({"seq": world}, device="cpu")
    t = data["q"].shape[1] // world
    out = {}
    for name, make in ATTN_IMPLS.items():
        fn = make(mesh)
        for causal in (False, True):
            qkv = [torch.tensor(data[x][:, rank * t:(rank + 1) * t])
                   .requires_grad_(True) for x in ("q", "k", "v")]
            with seq_chunk(mesh.seq_group, mesh.seq_size, mesh.seq_rank):
                o = fn(*qkv, causal)
            (o ** 2).sum().backward()
            key = f"{name}/{int(causal)}"
            out[key + "/o"] = o.detach().numpy()
            for x, leaf in zip(("dq", "dk", "dv"), qkv):
                out[f"{key}/{x}"] = leaf.grad.numpy()
    return out


def _linear_loss(p, b):
    return ((torch.as_tensor(b["x"]) @ p["w"]) ** 2).mean()


def lm_main(data, rank):
    params = unflatten([(k[2:], torch.tensor(v)) for k, v in data.items()
                        if k.startswith("p:")])
    batch = {"tokens": data["tokens"]}
    mesh = build_mesh(LM_AXES, device="cpu")
    out = {"mesh": np.array([mesh.data_size, mesh.seq_size, mesh.data_rank,
                             mesh.seq_rank, dist.get_world_size(
                                 mesh.seq_group),
                             dist.get_world_size(mesh.data_group)])}
    for name, (make, builder) in LM_ATTNS.items():
        _reset_default_autodist_for_testing()
        spec = transformer_lm(**LM_CFG, attn_fn=make(mesh))
        ad = AutoDist(strategy_builder=builder(), mesh_axes=LM_AXES,
                      device="cpu")
        with ad.scope():
            ad.capture(params=params, optimizer=optim.sgd(0.1),
                       loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars)
        sess = ad.create_distributed_session(mesh=mesh)
        out[f"{name}/losses"] = np.array(
            [float(sess.run(batch)["loss"]) for _ in range(LM_STEPS)])
        out[f"{name}/eval"] = np.array(float(sess.evaluate(batch)["loss"]))
        out[f"{name}/fingerprint"] = np.array(sess.schedule_fingerprint)
        out.update({f"{name}/p:{k}": np.asarray(v)
                    for k, v in flatten(sess.params)})
    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=AllReduce(), mesh_axes=LM_AXES,
                  device="cpu")
    with ad.scope():
        ad.capture(params={"w": torch.ones(4, 2)}, optimizer=optim.sgd(0.1),
                   loss_fn=_linear_loss)
    try:
        ad.create_distributed_session(mesh=mesh)
        out["other_raises"] = np.array("")
    except NotImplementedError as e:
        out["other_raises"] = np.array(str(e))
    assert str(out["other_raises"]).endswith(f"(ROADMAP: {P10})"), \
        out["other_raises"]
    return out


def main():
    rank, world, init, out, mode, inp = (int(sys.argv[1]),
                                         int(sys.argv[2]), sys.argv[3],
                                         sys.argv[4], sys.argv[5],
                                         sys.argv[6])
    torch.set_num_threads(1)
    torch_launch.init_process_group(init, world, rank)
    try:
        data = dict(np.load(inp))
        result = attn_main(data, world, rank) if mode == "attn" \
            else lm_main(data, rank)
        np.savez(out, **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
