"""One rank of a tensor-parallel run of the port on gloo CPU ranks (spawned
by ``tests/test_torch_model_axis.py``).

    python tests/torch_model_worker.py RANK WORLD INIT OUT.npz IN.npz DIR

(started by ``tests/torch_launch.py``; ``INIT`` is the group's init
method, a ``file://`` store).  Four ranks; ``IN`` holds the JAX weights
of :data:`LM_CFG` (``p:<name>``) and of :data:`A_CFG` (``a:<name>``),
their batches (``tokens``, ``a_tokens``) and the attention inputs ``q``,
``k``, ``v``; ``DIR`` the checkpoints.  In one process, in order:

* ``mesh``: the axis facts of ``{"data": 2, "model": 2}`` and of
  ``{"model": 2, "seq": 2}``;
* ``lm/<builder>`` for each of :data:`LM_BUILDERS` on
  :data:`MODEL_AXES` with ``fusable_adam(1e-2)`` and the clip, 3 steps:
  losses, global norms, the gathered parameters, and for each variable
  sharded over ``model`` the bytes this rank holds of it and of its
  moments beside the logical bytes;
* ``progA``: Program A's twin, ``PartitionedPS`` on :data:`SEQ_AXES`
  with ring attention and ``adamw(1e-3)``, 3 steps;
* ``progE``: Program E's partitioned leg, ``PartitionedAR(chunk_size=1,
  compressor="HorovodCompressorEF")`` against ``AllReduce(compressor=
  "HorovodCompressorEF")`` on :data:`MODEL_AXES`, ``sgd(0.1)``, 5 steps:
  losses, the shapes this rank holds, the gathered parameters and the
  logical error-feedback residuals; a RAM snapshot of the partitioned run
  (``checkpoint.tiers``) restored into a fresh session;
* ``flash``: ``make_flash_attention(mesh)`` on ``{"model": 4}``, causal
  and not, forward and the backward of ``sum(o ** 2)``, beside the call
  without a mesh and the call inside ``manual_axes``; ``flash_step``:
  ``PartitionedPS`` with the wrapper as the LM's attention against
  ``flash_attention`` itself, 2 steps and an evaluation;
* ``ckpt``: ``PartitionedPS`` on :data:`MODEL_AXES`, 2 steps, saved to
  ``DIR/tp``; its logical state written out; then ``DIR/one`` (a
  1-process ``PartitionedAR`` checkpoint the test wrote) restored into a
  ``PartitionedPS`` and a ``PartitionedAR`` session on the mesh, their
  logical states and one more step's loss;
* ``bad_moment``: a logical optimizer state with a wrongly shaped moment
  of a model-sharded variable, refused by ``import_state``.

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

from autodist_tpu_torch import optim  # noqa: E402
from autodist_tpu_torch import strategy  # noqa: E402
from autodist_tpu_torch.autodist import (  # noqa: E402
    AutoDist, _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import Saver  # noqa: E402
from autodist_tpu_torch.checkpoint.tiers import (  # noqa: E402
    capture_snapshot, load_snapshot)
from autodist_tpu_torch.graph_item import flatten, unflatten  # noqa: E402
from autodist_tpu_torch.kernel.graph_transformer import \
    map_var_leaves  # noqa: E402
from autodist_tpu_torch.mesh import build_mesh, manual_axes  # noqa: E402
from autodist_tpu_torch.models.transformer_lm import \
    transformer_lm  # noqa: E402
from autodist_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention, make_flash_attention)
from autodist_tpu_torch.ops.fused_kernels import fusable_adam  # noqa: E402
from autodist_tpu_torch.parallel import make_ring_attention  # noqa: E402

#: the LM of the PS family's tests (``tests/torch_dp_worker.py``)
LM_CFG = dict(vocab_size=97, num_layers=2, num_heads=2, head_dim=8,
              d_ff=32, max_len=16)
#: Program A's LM at model 2, seq 2, data 1 (``__graft_entry__.py:110-121``)
A_CFG = dict(vocab_size=128, num_layers=2, num_heads=4, head_dim=8,
             d_ff=32, max_len=32, seq_len=32)
MODEL_AXES = {"data": 2, "model": 2}
SEQ_AXES = {"model": 2, "seq": 2}
LM_BUILDERS = ("PartitionedPS", "PartitionedAR")
STEPS = 3
CLIP = 1.0


def _params(data, prefix):
    return unflatten([(k[len(prefix):], torch.tensor(v))
                      for k, v in data.items() if k.startswith(prefix)])


def _session(builder, params, loss_fn, opt, axes, mesh=None, **capture):
    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=builder, mesh_axes=axes, device="cpu")
    with ad.scope():
        ad.capture(params=params, optimizer=opt, loss_fn=loss_fn, **capture)
    return ad.create_distributed_session(mesh=mesh)


def _lm_session(builder, data, attn_fn=None):
    spec = transformer_lm(**LM_CFG, **({"attn_fn": attn_fn}
                                       if attn_fn else {}))
    sess = _session(builder, _params(data, "p:"), spec.loss_fn,
                    fusable_adam(1e-2), MODEL_AXES,
                    sparse_vars=spec.sparse_vars,
                    numerics={"clip_norm": CLIP})
    return sess, {"tokens": data["tokens"]}


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _shard_facts(out, prefix, sess):
    """Per model-sharded variable: ``[param bytes held, logical param
    bytes, moment bytes held, logical moment bytes]``."""
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


def _logical(out, prefix, sess):
    params, opt = sess.export_state()
    out.update({f"{prefix}/p:{k}": v.numpy() for k, v in flatten(params)})
    out.update({f"{prefix}/o:{k}": v.numpy() for k, v in flatten(opt)})


def lm_main(data, out):
    for name in LM_BUILDERS:
        sess, batch = _lm_session(getattr(strategy, name)(), data)
        results = [sess.run(batch) for _ in range(STEPS)]
        out[f"lm/{name}/losses"] = np.array([float(r["loss"])
                                             for r in results])
        out[f"lm/{name}/norms"] = np.array(
            [float(r["grad_health"].global_norm) for r in results])
        out.update({f"lm/{name}/p:{k}": v for k, v in flatten(sess.params)})
        out[f"lm/{name}/fingerprint"] = np.array(sess.schedule_fingerprint)
        _shard_facts(out, f"lm/{name}", sess)


def prog_a_main(data, out):
    mesh = build_mesh(SEQ_AXES, device="cpu")
    out["mesh/seq"] = np.array([mesh.model_size, mesh.seq_size,
                                mesh.model_rank, mesh.seq_rank,
                                dist.get_world_size(mesh.model_group),
                                dist.get_world_size(mesh.seq_group)])
    spec = transformer_lm(**A_CFG, attn_fn=make_ring_attention(mesh))
    sess = _session(strategy.PartitionedPS(), _params(data, "a:"),
                    spec.loss_fn, optim.adamw(1e-3), SEQ_AXES, mesh=mesh,
                    sparse_vars=spec.sparse_vars)
    batch = {"tokens": data["a_tokens"]}
    out["progA/losses"] = np.array([float(sess.run(batch)["loss"])
                                    for _ in range(STEPS)])
    out.update({f"progA/p:{k}": v for k, v in flatten(sess.params)})
    _shard_facts(out, "progA", sess)


def _partitioned_e():
    return strategy.PartitionedAR(chunk_size=1,
                                  compressor="HorovodCompressorEF")


def prog_e_main(out):
    from torch_dp_worker import prog_e_problem

    params, loss, batch = prog_e_problem(4)
    params = {k: torch.tensor(v) for k, v in params.items()}
    for name, builder in (
            ("partitioned", _partitioned_e()),
            ("replicated", strategy.AllReduce(
                compressor="HorovodCompressorEF"))):
        sess = _session(builder, params, loss, optim.sgd(0.1), MODEL_AXES)
        out[f"progE/{name}/losses"] = np.array(
            [float(sess.run(batch)["loss"]) for _ in range(5)])
        out[f"progE/{name}/held"] = np.array(sorted(
            f"{k}:{tuple(v.shape)}" for k, v in
            flatten(sess.sharded_params)))
        out[f"progE/{name}/sync"] = np.array(sorted(
            f"{k}:{tuple(v.shape)}" for k, v in flatten(sess.sync_state)))
        out.update({f"progE/{name}/p:{k}": v
                    for k, v in flatten(sess.params)})
        out.update({f"progE/{name}/ef:{k}": v.numpy()
                    for k, v in flatten(sess.export_sync_state())})
    # the partitioned run's RAM snapshot (model-sharded residuals in its
    # logical sync state) restored into a fresh session: the same state
    # bit for bit and the same next step
    sess = _session(_partitioned_e(), params, loss, optim.sgd(0.1),
                    MODEL_AXES)
    for _ in range(3):
        sess.run(batch)
    snap = capture_snapshot(sess)
    fresh = _session(_partitioned_e(), params, loss, optim.sgd(0.1),
                     MODEL_AXES)
    assert load_snapshot(fresh, snap) == 3
    same = []
    for a, b in ((dict(zip("po", sess.export_state())),
                  dict(zip("po", fresh.export_state()))),
                 (sess.export_sync_state(), fresh.export_sync_state()),
                 (sess.sync_state, fresh.sync_state)):
        fa, fb = flatten(a), flatten(b)
        same.append(len(fa) == len(fb) and all(
            na == nb and torch.equal(x, y)
            for (na, x), (nb, y) in zip(fa, fb)))
    out["progE/snapshot/same"] = np.array(same)
    out["progE/snapshot/next"] = np.array(
        [float(sess.run(batch)["loss"]), float(fresh.run(batch)["loss"])])


def flash_main(data, out):
    mesh = build_mesh({"model": 4}, device="cpu")
    sharded = make_flash_attention(mesh)
    for causal in (False, True):
        for label, fn in (("mesh", sharded), ("plain", flash_attention)):
            qkv = [torch.tensor(data[x]).requires_grad_(True)
                   for x in ("q", "k", "v")]
            o = fn(*qkv, causal)
            (o ** 2).sum().backward()
            key = f"flash/{label}/{int(causal)}"
            out[key + "/o"] = o.detach().numpy()
            for x, leaf in zip(("dq", "dk", "dv"), qkv):
                out[f"{key}/{x}"] = leaf.grad.numpy()
        with manual_axes():
            out[f"flash/local/{int(causal)}/o"] = sharded(
                *[torch.tensor(data[x]) for x in ("q", "k", "v")],
                causal).numpy()
    tp = build_mesh(MODEL_AXES, device="cpu")
    for label, attn in (("mesh", make_flash_attention(tp)),
                        ("plain", flash_attention)):
        sess, batch = _lm_session(strategy.PartitionedPS(), data, attn)
        out[f"flash_step/{label}/losses"] = np.array(
            [float(sess.run(batch)["loss"]) for _ in range(2)])
        out[f"flash_step/{label}/eval"] = np.array(
            float(sess.evaluate(batch)["loss"]))


def ckpt_main(data, out, directory):
    sess, batch = _lm_session(strategy.PartitionedPS(), data)
    for _ in range(2):
        sess.run(batch)
    Saver(sess).save(os.path.join(directory, "tp"), step=2)
    _logical(out, "ckpt/tp", sess)
    for name in ("PartitionedPS", "PartitionedAR"):
        sess, batch = _lm_session(getattr(strategy, name)(), data)
        step = Saver(sess).restore(Saver.latest_checkpoint(
            os.path.join(directory, "one")))
        _logical(out, f"ckpt/one/{name}", sess)
        out[f"ckpt/one/{name}/step"] = np.array(step)
        out[f"ckpt/one/{name}/loss"] = np.array(float(sess.run(batch)[
            "loss"]))


def bad_moment_main(data, out):
    """A logical optimizer state with one moment of a model-sharded
    variable a row too long, imported into a ``PartitionedPS`` session:
    ``"<variable>|<the ValueError's message>"``."""
    sess, _ = _lm_session(strategy.PartitionedPS(), data)
    params, opt = sess.export_state()
    victim = []

    shards = sess._step.model_shards

    def grow(x, n):
        if victim:
            return x
        victim.append(n)
        shape = list(x.shape)
        shape[shards[n][0]] += 1
        return torch.zeros(shape)
    bad = map_var_leaves(opt, shards, grow)
    try:
        sess.import_state(params, bad)
        out["bad_moment"] = np.array(f"{victim[0]}|")
    except ValueError as e:
        out["bad_moment"] = np.array(f"{victim[0]}|{e}")


def main():
    rank, world, init, out_path, inp, directory = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6])
    torch.set_num_threads(1)
    torch_launch.init_process_group(init, world, rank)
    try:
        data = dict(np.load(inp))
        mesh = build_mesh(MODEL_AXES, device="cpu")
        out = {"mesh/model": np.array([
            mesh.data_size, mesh.model_size, mesh.data_rank,
            mesh.model_rank, dist.get_world_size(mesh.model_group),
            dist.get_world_size(mesh.data_group)])}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            lm_main(data, out)
        out["warnings"] = np.array(sorted({str(w.message)
                                           for w in caught}))
        prog_a_main(data, out)
        prog_e_main(out)
        flash_main(data, out)
        ckpt_main(data, out, directory)
        bad_moment_main(data, out)
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
