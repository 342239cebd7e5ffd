"""One rank of a pipeline-parallel run of the port on gloo CPU ranks
(spawned by ``tests/test_torch_pipeline.py``).

    python tests/torch_pipe_worker.py RANK WORLD INIT OUT.npz IN.npz DIR

(started by ``tests/torch_launch.py``; ``INIT`` is the group's init
method, a ``file://`` store).  Four ranks; ``IN`` holds the JAX weights of
each LM of :data:`LMS` (``<lm>:<name>``) and their batches
(``<lm>/tokens``); ``DIR`` the checkpoints.  The schedules' inputs are
drawn here and in the test by :func:`apply_inputs` and
:func:`f1b_inputs`.  In one process, in order:

* ``mesh/<axes>``: the pipe axis's facts on ``{"pipe": 4}``,
  ``{"pipe": 2, "data": 2}`` and ``{"pipe": 2, "expert": 2}``;
* ``apply/<case>``: ``pipeline_apply`` of each :data:`APPLY_CASES` entry,
  outside a step (the whole stack: the output and the gradients of
  ``sum(y**2)`` w.r.t. the input and the whole stack) and inside one
  (this rank's chunks: the output and their gradients);
* ``f1b/<case>``: ``one_f_one_b`` of each :data:`F1B_CASES` entry outside
  a step (loss, the whole stack's, the head's and the input's
  gradients), and inside one for ``p4_v2_m8`` (this rank's chunks);
* ``vg/<lm>``: each LM's loss and gradients outside a step: ``loss_fn``
  by autograd through ``pipeline_apply``, or the 1F1B ``grad_fn``;
* ``train/<run>``: each :data:`TRAIN_RUNS` entry trained
  :data:`STEPS` steps through the session with ``fusable_adam(1e-2)``
  and the clip: losses, global norms, the parameters' digest, the
  gathered parameters, the evaluation outside a step, the schedule
  fingerprint, and for each stage stack the bytes this rank holds of it
  and of its moments beside the logical bytes;
* ``ckpt``: ``AllReduce`` on ``{"pipe": 2, "data": 2}``, 2 steps, saved to
  ``DIR/pp``, its logical state and next loss; then ``DIR/one`` (a
  1-process checkpoint the test wrote) restored on the pipe mesh: its
  logical state and one more step's loss.

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
from autodist_tpu_torch.mesh import build_mesh, manual_axes  # noqa: E402
from autodist_tpu_torch.models import (  # noqa: E402
    pipelined_moe_transformer_lm, pipelined_transformer_lm)
from autodist_tpu_torch.ops.fused_kernels import fusable_adam  # noqa: E402
from autodist_tpu_torch.parallel.pipeline import (  # noqa: E402
    interleaved_stage_order, pipeline_apply)
from autodist_tpu_torch.parallel.pipeline_1f1b import \
    one_f_one_b  # noqa: E402

P4 = {"pipe": 4}
PD = {"pipe": 2, "data": 2}
PE = {"pipe": 2, "expert": 2}
#: pipeline_apply's cases: (mesh, virtual stages, microbatches, remat),
#: on the JAX test's sizes (``tests/test_pipeline.py``: B 8, D 16);
#: ``p4_v1_m2`` has fewer microbatches than stages
APPLY_CASES = {"p4_v1": (P4, 1, None, False), "p4_v1_m8": (P4, 1, 8, False),
               "p4_v1_m2": (P4, 1, 2, False),
               "p4_v1_remat": (P4, 1, None, True),
               "p4_v2_m4": (P4, 2, 4, False), "p4_v2_m8": (P4, 2, 8, False),
               "pd_v1": (PD, 1, None, False), "pd_v2_m4": (PD, 2, 4, False)}
APPLY_B, APPLY_D = 8, 16
#: one_f_one_b's cases: (mesh, virtual stages, microbatches, batch, with
#: a head), on the JAX test's sizes (``tests/test_pipeline_1f1b.py``: D
#: 12); ``pd_v2_m4_head`` is its data-axis case on 4 ranks
F1B_CASES = {"p4_v1_m4": (P4, 1, 4, 16, False),
             "p4_v1_m8_head": (P4, 1, 8, 16, True),
             "p4_v2_m8": (P4, 2, 8, 16, False),
             "p4_v2_m6": (P4, 2, 6, 12, False),
             "pd_v2_m4_head": (PD, 2, 4, 16, True),
             "pd_v1_m2": (PD, 1, 2, 16, False)}
F1B_D = 12
#: the LMs: (factory, config); ``lm`` and ``moe`` are the JAX tests'
#: sizes (``tests/test_pipeline.py``, ``tests/test_moe.py``), ``d`` and
#: ``b`` the shapes of Programs D and B of ``__graft_entry__``
LM_CFG = dict(vocab_size=64, num_layers=4, num_heads=2, head_dim=8,
              d_ff=32, max_len=16, seq_len=16)
LMS = {
    "lm": ("lm", LM_CFG),
    "lm_v2": ("lm", dict(LM_CFG, num_layers=8, num_virtual_stages=2)),
    "d": ("lm", dict(LM_CFG, num_virtual_stages=2, num_microbatches=2,
                     schedule="1f1b")),
    "moe": ("moe", dict(LM_CFG, num_experts=2)),
    "b": ("moe", dict(LM_CFG, vocab_size=128, num_experts=4)),
}
#: the pipe size each LM's stored stack is laid out for (device-major
#: for V > 1)
LM_STAGES = {"lm": 2, "lm_v2": 4, "d": 2, "moe": 2, "b": 2}
#: the LMs' value-and-grad cases outside a step: (lm, mesh, batch)
VG_CASES = {"lm_pd": ("lm", PD, 8), "lm_v2_p4": ("lm_v2", P4, 8),
            "d_pd": ("d", PD, 4), "moe_pe": ("moe", PE, 8)}
#: the session runs: (lm, mesh, builder, batch rows)
TRAIN_RUNS = {"lm_pd": ("lm", PD, "PSLoadBalancing", 8),
              "lm_p4": ("lm", P4, "PSLoadBalancing", 8),
              "lm_pd_ar": ("lm", PD, "AllReduce", 8),
              "d_pd": ("d", PD, "PSLoadBalancing", 4),
              "b_pe": ("b", PE, "PSLoadBalancing", 8)}
STEPS = 3
CLIP = 1.0


def stages_in_pipeline_order(rng, n, d):
    """``n`` stages of ``tanh(x @ w + b)`` (the JAX tests' draws)."""
    return [{"w": (rng.standard_normal((d, d)) * 0.3).astype(np.float32),
             "b": (rng.standard_normal(d) * 0.1).astype(np.float32)}
            for _ in range(n)]


def device_major(stages, s, v):
    """The stages stacked device-major (``interleaved_stage_order``)."""
    order = interleaved_stage_order(s, v)
    return {k: np.stack([stages[g][k] for g in order]) for k in ("w", "b")}


def apply_inputs(label):
    """``(device-major stack, pipeline-order stages, x)`` of an apply
    case."""
    axes, v, _, _ = APPLY_CASES[label]
    s = axes["pipe"]
    rng = np.random.default_rng(sorted(APPLY_CASES).index(label))
    stages = stages_in_pipeline_order(rng, s * v, APPLY_D)
    x = rng.standard_normal((APPLY_B, APPLY_D)).astype(np.float32)
    return device_major(stages, s, v), stages, x


def f1b_inputs(label):
    """``(device-major stack, x, targets, head)`` of a 1F1B case."""
    axes, v, _, b, _ = F1B_CASES[label]
    s = axes["pipe"]
    rng = np.random.default_rng(100 + sorted(F1B_CASES).index(label))
    stages = stages_in_pipeline_order(rng, s * v, F1B_D)
    x = rng.standard_normal((b, F1B_D)).astype(np.float32)
    t = rng.standard_normal((b, F1B_D)).astype(np.float32)
    head = {"w": (rng.standard_normal((F1B_D, F1B_D)) * 0.3).astype(
        np.float32)}
    return device_major(stages, s, v), x, t, head


def pipeline_rows(lm):
    """The stored stack's rows in pipeline order (identity for V = 1):
    pipeline layer ``g·lpc + k`` is stored at row
    ``order.index(g)·lpc + k``."""
    cfg = LMS[lm][1]
    s, v = LM_STAGES[lm], cfg.get("num_virtual_stages", 1)
    lpc = cfg["num_layers"] // (s * v)
    order = interleaved_stage_order(s, v)
    return [order.index(g) * lpc + k for g in range(s * v)
            for k in range(lpc)]


def stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def loss_fn(y, t):
    return ((y - t) ** 2).mean()


def head_loss(lp, y, t):
    return ((y @ lp["w"] - t) ** 2).mean()


def make_spec(lm, mesh):
    kind, cfg = LMS[lm]
    factory = pipelined_transformer_lm if kind == "lm" \
        else pipelined_moe_transformer_lm
    return factory(mesh, **cfg)


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _np(tree):
    return {k: v.detach().numpy() for k, v in tree.items()}


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def mesh_main(out):
    for label, axes in (("p4", P4), ("pd", PD), ("pe", PE)):
        mesh = build_mesh(axes, device="cpu")
        out[f"mesh/{label}"] = np.array([
            mesh.pipe_size, mesh.data_size, mesh.expert_size,
            mesh.pipe_rank, mesh.data_rank, mesh.expert_rank,
            dist.get_world_size(mesh.pipe_group)])


def apply_main(out):
    for label, (axes, v, m, remat) in APPLY_CASES.items():
        mesh = build_mesh(axes, device="cpu")
        stack, _, x = apply_inputs(label)
        d = mesh.pipe_rank
        for where in ("out", "in"):
            params = {k: torch.tensor(a[d * v:(d + 1) * v] if where == "in"
                                      else a).requires_grad_()
                      for k, a in stack.items()}
            xx = torch.tensor(x).requires_grad_()
            kw = dict(num_microbatches=m, num_virtual_stages=v, remat=remat)
            if where == "in":
                with manual_axes():
                    y = pipeline_apply(stage_fn, params, xx, mesh, **kw)
            else:
                y = pipeline_apply(stage_fn, params, xx, mesh, **kw)
            (y ** 2).sum().backward()
            prefix = f"apply/{label}/{where}"
            out[f"{prefix}/y"] = y.detach().numpy()
            out[f"{prefix}/dx"] = xx.grad.numpy()
            for k, p in params.items():
                out[f"{prefix}/d{k}"] = p.grad.numpy()


def f1b_main(out):
    for label, (axes, v, m, _, with_head) in F1B_CASES.items():
        mesh = build_mesh(axes, device="cpu")
        stack, x, t, head = f1b_inputs(label)
        kw = dict(num_microbatches=m, num_virtual_stages=v)
        if with_head:
            loss, dsp, dlp, dx = one_f_one_b(
                stage_fn, head_loss, _t(stack), torch.tensor(x),
                torch.tensor(t), mesh, loss_params=_t(head), **kw)
            out[f"f1b/{label}/dw_head"] = dlp["w"].numpy()
        else:
            loss, dsp, dx = one_f_one_b(stage_fn, loss_fn, _t(stack),
                                        torch.tensor(x), torch.tensor(t),
                                        mesh, **kw)
        out[f"f1b/{label}/loss"] = loss.numpy()
        out[f"f1b/{label}/dx"] = dx.numpy()
        out.update({f"f1b/{label}/d{k}": g.numpy() for k, g in dsp.items()})
    # inside a step: this rank's chunks, their gradients
    label = "p4_v2_m8"
    axes, v, m, _, _ = F1B_CASES[label]
    mesh = build_mesh(axes, device="cpu")
    stack, x, t, _ = f1b_inputs(label)
    d = mesh.pipe_rank
    with manual_axes():
        loss, dsp, dx = one_f_one_b(
            stage_fn, loss_fn, _t({k: a[d * v:(d + 1) * v]
                                   for k, a in stack.items()}),
            torch.tensor(x), torch.tensor(t), mesh, num_microbatches=m,
            num_virtual_stages=v)
    out[f"f1b/{label}/in/loss"] = loss.numpy()
    out[f"f1b/{label}/in/dx"] = dx.numpy()
    out.update({f"f1b/{label}/in/d{k}": g.numpy() for k, g in dsp.items()})


def _lm_params(data, lm):
    prefix = f"{lm}:"
    return params_from_jax({k[len(prefix):]: v for k, v in data.items()
                            if k.startswith(prefix)})


def vg_main(data, out):
    for label, (lm, axes, b) in VG_CASES.items():
        mesh = build_mesh(axes, device="cpu")
        spec = make_spec(lm, mesh)
        params = _lm_params(data, lm)
        batch = {"tokens": data[f"{lm}/tokens"][:b]}
        if spec.grad_fn is not None:
            loss, grads = spec.grad_fn(params, batch)
            grads = dict(flatten(grads))
        else:
            leaves = [x.requires_grad_() for _, x in flatten(params)]
            loss = spec.loss_fn(params, batch)
            got = torch.autograd.grad(loss, leaves)
            grads = dict(zip([n for n, _ in flatten(params)], got))
        out[f"vg/{label}/loss"] = loss.detach().numpy()
        out.update({f"vg/{label}/g:{k}": g.detach().numpy()
                    for k, g in grads.items()})


def session(data, lm, axes, builder, mesh=None):
    """The LM ``lm`` captured on ``axes`` under ``builder`` with
    ``fusable_adam(1e-2)`` and the clip (its 1F1B ``grad_fn`` when it has
    one): the session and its batch."""
    _reset_default_autodist_for_testing()
    mesh = mesh or build_mesh(axes, device="cpu")
    spec = make_spec(lm, mesh)
    ad = AutoDist(strategy_builder=getattr(strategy, builder)(),
                  mesh_axes=axes, device="cpu")
    with ad.scope():
        ad.capture(params=_lm_params(data, lm), optimizer=fusable_adam(1e-2),
                   loss_fn=spec.loss_fn, grad_fn=spec.grad_fn,
                   sparse_vars=spec.sparse_vars,
                   pipeline_vars=spec.pipeline_vars,
                   expert_vars=spec.expert_vars,
                   numerics={"clip_norm": CLIP})
    return ad.create_distributed_session(mesh=mesh)


def _shard_facts(out, prefix, sess):
    """Per sharded variable: ``[param bytes held, logical param bytes,
    moment bytes held, logical moment bytes]``."""
    cuts = sess._step.shard_cuts
    held = dict(flatten(sess.device_params))
    infos = {v.name: v for v in sess._gi.info.variables}
    moments = {}
    tree = sess.opt_state["vars"] if sess.zero1_buckets else sess.opt_state
    map_var_leaves(tree, cuts, lambda x, n: moments.__setitem__(
        n, moments.get(n, 0) + _nbytes(x)))
    for n in cuts:
        full = infos[n].byte_size
        out[f"{prefix}/shard:{n}"] = np.array(
            [_nbytes(held[n]), full, moments.get(n, 0), 2 * full])


def train_main(data, out):
    for label, (lm, axes, builder, b) in TRAIN_RUNS.items():
        sess = session(data, lm, axes, builder)
        batch = {"tokens": data[f"{lm}/tokens"][:b]}
        results = [sess.run(batch) for _ in range(STEPS)]
        prefix = f"train/{label}"
        out[f"{prefix}/losses"] = np.array([float(r["loss"])
                                            for r in results])
        out[f"{prefix}/norms"] = np.array(
            [float(r["grad_health"].global_norm) for r in results])
        params = sess.params
        out[f"{prefix}/digest"] = np.array(tree_digest(params))
        out.update({f"{prefix}/p:{k}": np.asarray(v)
                    for k, v in flatten(params)})
        out[f"{prefix}/eval"] = np.array(float(
            sess.evaluate(batch)["loss"]))
        out[f"{prefix}/fingerprint"] = np.array(sess.schedule_fingerprint)
        out[f"{prefix}/cut"] = np.array(sorted(sess._step.shard_cuts))
        _shard_facts(out, prefix, sess)


def _logical(out, prefix, sess):
    params, opt = sess.export_state()
    out.update({f"{prefix}/p:{k}": v.numpy() for k, v in flatten(params)})
    out.update({f"{prefix}/o:{k}": v.numpy() for k, v in flatten(opt)})


def ckpt_main(data, out, directory):
    batch = {"tokens": data["lm/tokens"]}
    sess = session(data, "lm", PD, "AllReduce")
    for _ in range(2):
        sess.run(batch)
    Saver(sess).save(os.path.join(directory, "pp"), step=2)
    _logical(out, "ckpt/pp", sess)
    out["ckpt/pp/next"] = np.array(float(sess.run(batch)["loss"]))
    sess = session(data, "lm", PD, "AllReduce")
    step = Saver(sess).restore(Saver.latest_checkpoint(
        os.path.join(directory, "one")))
    _logical(out, "ckpt/one", sess)
    out["ckpt/one/step"] = np.array(step)
    out["ckpt/one/loss"] = np.array(float(sess.run(batch)["loss"]))


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
        apply_main(out)
        f1b_main(out)
        vg_main(data, out)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            train_main(data, out)
        out["warnings"] = np.array(sorted({str(w.message)
                                           for w in caught}))
        ckpt_main(data, out, directory)
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
