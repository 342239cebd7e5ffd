"""One rank of an expert-parallel run of the port on gloo CPU ranks (spawned
by ``tests/test_torch_moe.py``).

    python tests/torch_moe_worker.py RANK WORLD INIT OUT.npz IN.npz DIR

(started by ``tests/torch_launch.py``; ``INIT`` is the group's init
method, a ``file://`` store).  Four ranks; ``IN`` holds the JAX weights of
the MoE LM at :data:`LM_CFG` (``p:<name>``) and its batch (``tokens``),
the FFN's JAX weights and input (``ffn:<name>``, ``ffn_x``, ``ffn_w``), the
int8 construction's (``exact:<name>``, ``exact_x``) and the wire case's
tensor and weights (``wire_t``, ``wire_w``); ``DIR`` the checkpoints.  In
one process, in order:

* ``mesh``: the axis facts of :data:`AXES_DE`, :data:`AXES_EM` and
  ``{"expert": 4}``;
* ``ffn/<mesh>``: ``moe_ffn`` on ``{"expert": 4}`` and :data:`AXES_DE`
  with this rank's experts of ``wi``/``wo`` (and with all of them), ``y``,
  aux and the gradients of ``sum(y · w) + aux`` (``x``, the router, this
  rank's experts); the int8 wire's exact construction and the generic
  inputs under both wires;
* ``wire``: the quantized all-to-all of this rank's groups of ``wire_t``
  on ``{"expert": 4}``, its output and the gradient of ``sum(out · w)``;
* ``lm/<builder>``: the MoE LM trained 3 steps with ``fusable_adam(1e-2)``
  and the clip by each of :data:`LM_RUNS` on its mesh: losses, global
  norms, the parameters' digest, the gathered parameters, the
  evaluation outside a step (the MoE layers over ``expert``), and for
  each expert- or model-sharded variable the bytes this rank holds of it
  and of its moments beside the logical bytes;
* ``ckpt``: ``PSLoadBalancing`` on :data:`AXES_DE`, 2 steps, saved to
  ``DIR/ep``, its logical state and next loss written out; then
  ``DIR/one`` (a 1-process ``AllReduce`` checkpoint the test wrote)
  restored into each of :data:`RESTORE_INTO` on the mesh: their logical
  states and one more step's loss.

Each rank runs one intra-op thread.
"""
import os
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_launch  # noqa: E402

from autodist_tpu_torch import strategy  # noqa: E402
from autodist_tpu_torch.autodist import (  # noqa: E402
    AutoDist, _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import Saver  # noqa: E402
from autodist_tpu_torch.checkpoint.saver import tree_digest  # noqa: E402
from autodist_tpu_torch.convert import params_from_jax  # noqa: E402
from autodist_tpu_torch.graph_item import flatten  # noqa: E402
from autodist_tpu_torch.kernel.graph_transformer import \
    map_var_leaves  # noqa: E402
from autodist_tpu_torch.mesh import build_mesh  # noqa: E402
from autodist_tpu_torch.models.moe_lm import moe_transformer_lm  # noqa: E402
from autodist_tpu_torch.ops.fused_kernels import fusable_adam  # noqa: E402
from autodist_tpu_torch.ops.quant_scale import WIRE_INT8  # noqa: E402
from autodist_tpu_torch.parallel.moe import (  # noqa: E402
    _wire_all_to_all, moe_ffn)

#: the JAX package's MoE LM test size (``tests/test_moe.py``)
LM_CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
              d_ff=32, num_experts=4, max_len=16, seq_len=16)
AXES_DE = {"data": 2, "expert": 2}
AXES_EM = {"expert": 2, "model": 2}
#: (label, builder, mesh) of the LM runs
LM_RUNS = (("PSLoadBalancing", AXES_DE), ("Parallax", AXES_DE),
           ("PartitionedPS", AXES_EM))
#: the builders the 1-process (``AllReduce``) checkpoint restores into
RESTORE_INTO = ("PSLoadBalancing", "AllReduce")
STEPS = 3
CLIP = 1.0


def _params(data, prefix):
    return params_from_jax({k[len(prefix):]: v for k, v in data.items()
                            if k.startswith(prefix)})


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def mesh_main(out):
    for label, axes in (("de", AXES_DE), ("em", AXES_EM),
                        ("e4", {"expert": 4})):
        mesh = build_mesh(axes, device="cpu")
        out[f"mesh/{label}"] = np.array([
            mesh.data_size, mesh.expert_size, mesh.model_size,
            mesh.data_rank, mesh.expert_rank, mesh.model_rank,
            dist.get_world_size(mesh.expert_group)])


def _ffn_call(params, x, w, mesh, **kw):
    """``y``, aux and the gradients of ``sum(y · w) + aux``."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    x = x.clone().requires_grad_(True)
    y, aux = moe_ffn(leaves, x, mesh=mesh, **kw)
    ((y * w).sum() + aux).backward()
    return {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
            "dx": x.grad.numpy(),
            **{f"d{k}": v.grad.numpy() for k, v in leaves.items()}}


def ffn_main(data, out):
    full = _params(data, "ffn:")
    x, w = torch.tensor(data["ffn_x"]), torch.tensor(data["ffn_w"])
    exact = _params(data, "exact:")
    for label, axes in (("e4", {"expert": 4}), ("de", AXES_DE)):
        mesh = build_mesh(axes, device="cpu")
        n, r = mesh.expert_size, mesh.expert_rank
        mine = {k: (v.chunk(n)[r].clone() if k != "router" else v)
                for k, v in full.items()}
        for kind, params in (("shard", mine), ("whole", full)):
            for k, v in _ffn_call(params, x, w, mesh).items():
                out[f"ffn/{label}/{kind}/{k}"] = v
        ident = dict(capacity_factor=4.0, activation=lambda t: t)
        ex = torch.tensor(data["exact_x"])
        mine = {k: (v.chunk(n)[r].clone() if k != "router" else v)
                for k, v in exact.items()}
        for wire in ("none", "int8"):
            y, aux = moe_ffn(mine, ex, mesh=mesh,
                             wire=None if wire == "none" else wire, **ident)
            out[f"exact/{label}/{wire}/y"] = y.numpy()
            out[f"exact/{label}/{wire}/aux"] = aux.numpy()
            y, _ = moe_ffn(full, x, mesh=mesh,
                           wire=None if wire == "none" else wire)
            out[f"generic/{label}/{wire}/y"] = y.numpy()


def wire_main(data, out):
    """The int8 all-to-all of this rank's groups (dim 1) to its experts
    (dim 0) and the gradient of ``sum(out · w)``."""
    mesh = build_mesh({"expert": 4}, device="cpu")
    n, r = mesh.expert_size, mesh.expert_rank
    t = torch.tensor(data["wire_t"]).chunk(n, dim=1)[r].clone()
    t.requires_grad_(True)
    got = _wire_all_to_all(t, mesh.expert_group, 0, 1, WIRE_INT8)
    w = torch.tensor(data["wire_w"]).chunk(n, dim=0)[r]
    (got * w).sum().backward()
    out["wire/out"] = got.detach().numpy()
    out["wire/grad"] = t.grad.numpy()


def _lm_session(builder, data, axes, mesh=None):
    _reset_default_autodist_for_testing()
    mesh = mesh or build_mesh(axes, device="cpu")
    spec = moe_transformer_lm(mesh, **LM_CFG)
    ad = AutoDist(strategy_builder=builder, mesh_axes=axes, device="cpu")
    with ad.scope():
        ad.capture(params=_params(data, "p:"), optimizer=fusable_adam(1e-2),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   expert_vars=spec.expert_vars,
                   numerics={"clip_norm": CLIP})
    return ad.create_distributed_session(mesh=mesh), \
        {"tokens": data["tokens"]}


def _shard_facts(out, prefix, sess):
    """Per expert- or model-sharded variable: ``[param bytes held,
    logical param bytes, moment bytes held, logical moment bytes]`` and
    ``[dim, shards, this rank's shard]``."""
    shards = sess._step.model_shards
    held = dict(flatten(sess.device_params))
    moments = {}
    tree = sess.opt_state["vars"] if sess.zero1_buckets else sess.opt_state
    map_var_leaves(tree, shards, lambda x, n: moments.__setitem__(
        n, moments.get(n, 0) + _nbytes(x)))
    for n, (dim, k, rank) in shards.items():
        full = _nbytes(held[n]) * k
        out[f"{prefix}/shard:{n}"] = np.array(
            [_nbytes(held[n]), full, moments.get(n, 0), 2 * full])
        out[f"{prefix}/rank:{n}"] = np.array([dim, k, rank])


def lm_main(data, out):
    for name, axes in LM_RUNS:
        sess, batch = _lm_session(getattr(strategy, name)(), data, axes)
        results = [sess.run(batch) for _ in range(STEPS)]
        prefix = f"lm/{name}"
        out[f"{prefix}/losses"] = np.array([float(r["loss"])
                                            for r in results])
        out[f"{prefix}/norms"] = np.array(
            [float(r["grad_health"].global_norm) for r in results])
        params = sess.params
        out[f"{prefix}/digest"] = np.array(tree_digest(params))
        out.update({f"{prefix}/p:{k}": v for k, v in flatten(params)})
        out[f"{prefix}/eval"] = np.array(float(
            sess.evaluate(batch)["loss"]))
        out[f"{prefix}/fingerprint"] = np.array(sess.schedule_fingerprint)
        out[f"{prefix}/sharded"] = np.array(sorted(sess._step.model_shards))
        _shard_facts(out, prefix, sess)


def _logical(out, prefix, sess):
    params, opt = sess.export_state()
    out.update({f"{prefix}/p:{k}": v.numpy() for k, v in flatten(params)})
    out.update({f"{prefix}/o:{k}": v.numpy() for k, v in flatten(opt)})


def ckpt_main(data, out, directory):
    builder = strategy.PSLoadBalancing
    sess, batch = _lm_session(builder(), data, AXES_DE)
    for _ in range(2):
        sess.run(batch)
    Saver(sess).save(os.path.join(directory, "ep"), step=2)
    _logical(out, "ckpt/ep", sess)
    out["ckpt/ep/next"] = np.array(float(sess.run(batch)["loss"]))
    for name in RESTORE_INTO:
        sess, batch = _lm_session(getattr(strategy, name)(), data, AXES_DE)
        step = Saver(sess).restore(Saver.latest_checkpoint(
            os.path.join(directory, "one")))
        prefix = f"ckpt/one/{name}"
        _logical(out, prefix, sess)
        out[f"{prefix}/step"] = np.array(step)
        out[f"{prefix}/loss"] = np.array(float(sess.run(batch)["loss"]))


def main():
    rank, world, init, out_path, inp, directory = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6])
    torch.set_num_threads(1)
    torch_launch.init_process_group(init, world, rank)
    try:
        data = dict(np.load(inp))
        out = {}
        mesh_main(out)
        ffn_main(data, out)
        wire_main(data, out)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            lm_main(data, out)
        out["warnings"] = np.array(sorted({str(w.message)
                                           for w in caught}))
        ckpt_main(data, out, directory)
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
