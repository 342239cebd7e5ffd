"""The port's pipe axis, its schedules and the pipelined LMs against the
JAX package.

* the tick, bubble and microbatch helpers equal JAX's; the schedules'
  validation errors are JAX's;
* on 4 gloo ranks (one launch of ``tests/torch_pipe_worker.py``), each
  rank computing only its own chunks: the pipe mesh's layout;
  ``pipeline_apply`` (GPipe and interleaved, on ``{"pipe": 4}`` and
  ``{"pipe": 2, "data": 2}``, outside a step and inside one) against
  JAX's on the conftest's CPU mesh: values at rtol/atol 1e-5, gradients
  at rtol 1e-4 / atol 1e-5 (``tests/test_pipeline.py``); ``one_f_one_b``
  (V 1, 2; a head; a data axis) against JAX's: the loss at rtol 1e-6,
  gradients at rtol 1e-5 / atol 1e-6 (``tests/test_pipeline_1f1b.py``);
  the pipelined LMs' loss and gradients on a pipe mesh (the 1F1B
  ``grad_fn`` too) against ``jax.value_and_grad`` at the schedules'
  tolerances;
* the pipelined LMs at one process against ``jax.value_and_grad`` at
  rtol 1e-5;
* both LMs trained through the session on ``{"pipe": 2, "data": 2}``,
  ``{"pipe": 4}`` and Programs B's and D's shapes (``{"pipe": 2,
  "expert": 2}``; interleaved 1F1B through ``capture(grad_fn=)``):
  losses and global norms within 1e-5 of one process (the same logical
  layers, in pipeline order), one digest, each stage stack's ``1/S`` a
  rank (``1/(S·X)`` of the expert stacks) with its moments;
* the compiler's plans on ``{"pipe": 2, "data": 2}`` and ``{"pipe": 2,
  "expert": 2}`` equal JAX's, the step's IR JSON and fingerprint equal
  JAX's ``build_schedule_ir``; a pipe-mesh checkpoint restores on one
  process bit for bit, and the reverse.

Torch runs one intra-op thread.
"""
import logging as stdlib_logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autodist_tpu.strategy as jstrategy
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.kernel.synchronization import overlap as joverlap
from autodist_tpu.kernel.synchronization import schedule_ir as jsir
from autodist_tpu.mesh import build_mesh as jax_build_mesh
from autodist_tpu.models.pipelined_lm import \
    pipelined_transformer_lm as jax_pipelined_lm
from autodist_tpu.models.pipelined_moe_lm import \
    pipelined_moe_transformer_lm as jax_pipelined_moe_lm
from autodist_tpu.ops import fused_kernels as jfk
from autodist_tpu.parallel import pipeline as jpipeline
from autodist_tpu.parallel import pipeline_1f1b as jpipeline_1f1b
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import optim, strategy
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.graph_item import GraphItem, flatten
from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
from autodist_tpu_torch.kernel.synchronization.explicit_sync import (
    partition_support, pipe_support, plan_step)
from autodist_tpu_torch.mesh import Mesh
from autodist_tpu_torch.models import (pipelined_moe_transformer_lm,
                                       pipelined_transformer_lm)
from autodist_tpu_torch.models.pipelined_lm import _device_major_layers
from autodist_tpu_torch.ops.fused_kernels import fusable_adam
from autodist_tpu_torch.parallel import pipeline, pipeline_1f1b
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import StrategyCompiler
from autodist_tpu_torch.strategy.base import Strategy

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_launch  # noqa: E402
import torch_pipe_worker as worker  # noqa: E402
from test_torch_model_axis import _jax_buckets  # noqa: E402

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_pipe_worker.py"
BUILDERS = ("PS", "PSLoadBalancing", "PartitionedPS", "UnevenPartitionedPS",
            "AllReduce", "PartitionedAR", "RandomAxisPartitionAR",
            "Parallax", "Zero1")
IR_BUILDERS = ("PSLoadBalancing", "Parallax", "PartitionedPS", "AllReduce",
               "Zero1")
#: the plans' and IR's catalogs: (mesh, lm)
PLAN_MESHES = {"pd": (worker.PD, "lm"), "pe": (worker.PE, "moe")}
ONE_NODE = {"nodes": [{"address": "localhost", "chips": 4}]}
NUMERICS = {"clip_norm": worker.CLIP}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    _reset_default_autodist_for_testing()


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_build_mesh(axes, devices=jax.devices()[:n])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_spec(lm, mesh=None):
    kind, cfg = worker.LMS[lm]
    factory = jax_pipelined_lm if kind == "lm" else jax_pipelined_moe_lm
    return factory(mesh or _jax_mesh({"pipe": worker.LM_STAGES[lm]}), **cfg)


@pytest.fixture(scope="module")
def lm_inputs():
    """Each LM's JAX weights (threefry init, stored for its pipe size)
    and a batch of 8 rows."""
    out = {}
    for lm in worker.LMS:
        jspec = _jax_spec(lm)
        out[lm] = (_np(jspec.init(jax.random.PRNGKey(0))),
                   jspec.sample_batch(8)["tokens"])
    return out


def _pipeline_order(lm, params):
    """``params`` (numpy, as stored) with the stack in pipeline order."""
    rows = worker.pipeline_rows(lm)
    flat = dict(flatten(params))
    return {k: (v[rows] if k.startswith("stack/") else v)
            for k, v in flat.items()}


def _one_spec(lm, **kw):
    """The port's LM at pipe 1 (the plain loop over the stack)."""
    kind, cfg = worker.LMS[lm]
    cfg = dict(cfg, **kw)
    factory = pipelined_transformer_lm if kind == "lm" \
        else pipelined_moe_transformer_lm
    return factory(None, **cfg)


def _one_session(lm, builder, params, **kw):
    _reset_default_autodist_for_testing()
    spec = _one_spec(lm, schedule="gpipe")
    ad = AutoDist(strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params),
                   optimizer=fusable_adam(1e-2), loss_fn=spec.loss_fn,
                   sparse_vars=spec.sparse_vars,
                   pipeline_vars=spec.pipeline_vars,
                   expert_vars=spec.expert_vars, numerics=NUMERICS, **kw)
    return ad.create_distributed_session()


@pytest.fixture(scope="module")
def one_runs(lm_inputs):
    """Each training run's 1-process twin (the same logical layers in
    pipeline order, at pipe 1, GPipe's autograd): losses, global norms,
    parameters, the evaluation after the steps."""
    out = {}
    for label, (lm, _, builder, b) in worker.TRAIN_RUNS.items():
        params, tokens = lm_inputs[lm]
        sess = _one_session(lm, getattr(strategy, builder)(),
                            _pipeline_order(lm, params))
        batch = {"tokens": tokens[:b]}
        res = [sess.run(batch) for _ in range(worker.STEPS)]
        out[label] = ([float(r["loss"]) for r in res],
                      [float(r["grad_health"].global_norm) for r in res],
                      {k: np.asarray(v) for k, v in flatten(sess.params)},
                      float(sess.evaluate(batch)["loss"]))
    return out


@pytest.fixture(scope="module")
def one_ckpt(tmp_path_factory, lm_inputs):
    """A 1-process ``AllReduce`` checkpoint of the LM after 2 steps, its
    logical state and next loss."""
    params, tokens = lm_inputs["lm"]
    root = tmp_path_factory.mktemp("pipe")
    sess = _one_session("lm", strategy.AllReduce(), params)
    batch = {"tokens": tokens}
    for _ in range(2):
        sess.run(batch)
    Saver(sess).save(str(root / "one"), step=2)
    p, o = sess.export_state()
    state = {**{f"p:{k}": v.numpy() for k, v in flatten(p)},
             **{f"o:{k}": v.numpy() for k, v in flatten(o)}}
    return root, state, float(sess.run(batch)["loss"])


@pytest.fixture(scope="module")
def ranks(one_ckpt, lm_inputs):
    """One launch of 4 gloo ranks: every rank's outputs."""
    root, _, _ = one_ckpt
    inp = root / "in.npz"
    arrays = {}
    for lm, (params, tokens) in lm_inputs.items():
        arrays.update({f"{lm}:{k}": v for k, v in flatten(params)})
        arrays[f"{lm}/tokens"] = tokens
    np.savez(inp, **arrays)
    torch_launch.run(
        lambda rank, init: [WORKER, rank, 4, init, root / f"rank{rank}.npz",
                            inp, root],
        world=4, tmp_dir=root, timeout=600)
    return root, [dict(np.load(root / f"rank{r}.npz")) for r in range(4)]


# -- the mesh and the helpers -------------------------------------------------

def test_pipe_mesh_layout_on_four_ranks(ranks):
    """``build_mesh`` accepts ``pipe`` outermost in JAX's order: rank ``r``
    is stage ``r`` on ``{"pipe": 4}``, stage ``r // 2`` of data (or
    expert) rank ``r % 2`` on ``{"pipe": 2, "data": 2}`` (``{"pipe": 2,
    "expert": 2}``): the ranks of a data group share a stage."""
    for r, out in enumerate(ranks[1]):
        assert out["mesh/p4"].tolist() == [4, 1, 1, r, 0, 0, 4]
        assert out["mesh/pd"].tolist() == [2, 2, 1, r // 2, r % 2, 0, 2]
        assert out["mesh/pe"].tolist() == [2, 1, 2, r // 2, 0, r % 2, 2]


@pytest.mark.parametrize("s,m,v", [(4, 8, 1), (4, 8, 2), (2, 4, 2),
                                   (4, 6, 2), (4, 16, 4), (3, 7, 3),
                                   (8, 16, 1), (2, 3, 1)])
def test_schedule_helpers_equal_jax(s, m, v):
    """Ticks, bubbles, the device-major order and the default microbatch
    count equal JAX's (``schedule_ticks(4, 8) = 11``,
    ``schedule_ticks_1f1b(2, 4, 2) = 12``)."""
    assert pipeline.schedule_ticks(s, m, v) == \
        jpipeline.schedule_ticks(s, m, v)
    assert pipeline.bubble_fraction(s, m, v) == \
        jpipeline.bubble_fraction(s, m, v)
    assert pipeline_1f1b.schedule_ticks_1f1b(s, m, v) == \
        jpipeline_1f1b.schedule_ticks_1f1b(s, m, v)
    assert pipeline_1f1b.bubble_fraction_1f1b(s, m, v) == \
        jpipeline_1f1b.bubble_fraction_1f1b(s, m, v)
    assert pipeline.interleaved_stage_order(s, v) == \
        jpipeline.interleaved_stage_order(s, v)
    for b in (m, 2 * m, 3 * m + 1, 64):
        assert pipeline.default_num_microbatches(s, b) == \
            jpipeline.default_num_microbatches(s, b)
    assert pipeline.schedule_ticks(4, 8) == 11
    assert pipeline_1f1b.schedule_ticks_1f1b(2, 4, 2) == 12


def test_stack_and_device_major_layers_equal_jax():
    """``stack_stage_params`` and the LM's device-major layer order are
    JAX's."""
    rng = np.random.default_rng(0)
    stages = worker.stages_in_pipeline_order(rng, 4, 3)
    got = pipeline.stack_stage_params([{k: torch.tensor(v)
                                        for k, v in st.items()}
                                       for st in stages])
    want = jpipeline.stack_stage_params(stages)
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    from autodist_tpu.models.pipelined_lm import \
        _device_major_layers as jax_order
    layers = list(range(12))
    for s, v in ((2, 2), (2, 3), (3, 2), (4, 1)):
        assert _device_major_layers(layers, s, v) == jax_order(layers, s, v)


def test_schedule_validation_errors_are_jax_s():
    """``pipeline_apply`` and ``one_f_one_b`` refuse what JAX's refuse,
    with its messages, before any collective."""
    mesh = Mesh(shape={"pipe": 4}, device=torch.device("cpu"))
    stack = {k: torch.tensor(v) for k, v in
             worker.device_major(worker.stages_in_pipeline_order(
                 np.random.default_rng(0), 4, 6), 4, 1).items()}
    x = torch.zeros(8, 6)
    with pytest.raises(ValueError, match="not divisible into 3"):
        pipeline.pipeline_apply(worker.stage_fn, stack, x, mesh,
                                num_microbatches=3)
    with pytest.raises(ValueError, match="leading dim 4 != pipe axis size "
                                         "4 x 2 virtual stages"):
        pipeline.pipeline_apply(worker.stage_fn, stack, x, mesh,
                                num_virtual_stages=2)
    f1b = pipeline_1f1b.one_f_one_b
    with pytest.raises(ValueError, match="not divisible"):
        f1b(worker.stage_fn, worker.loss_fn, stack, x, x, mesh,
            num_microbatches=5)
    with pytest.raises(ValueError, match=">= stages"):
        f1b(worker.stage_fn, worker.loss_fn, stack, x, x, mesh,
            num_microbatches=2)
    with pytest.raises(ValueError, match="num_virtual_stages must be >= 1"):
        f1b(worker.stage_fn, worker.loss_fn, stack, x, x, mesh,
            num_microbatches=4, num_virtual_stages=0)
    with pytest.raises(ValueError, match="targets leading dim 4 != batch"):
        f1b(worker.stage_fn, worker.loss_fn, stack, x, x[:4], mesh,
            num_microbatches=4)
    with pytest.raises(ValueError, match="2 data shards x 8"):
        f1b(worker.stage_fn, worker.loss_fn, stack, x, x,
            Mesh(shape={"pipe": 4, "data": 2}, device=torch.device("cpu")),
            num_microbatches=8)


def test_no_pipe_axis_runs_the_stack_in_order():
    """At pipe size 1 ``pipeline_apply`` is the loop over the stage
    dimension, and ``one_f_one_b`` the autograd of it (a head here): JAX's
    fallbacks, at the JAX tests' tolerances."""
    stack, stages, x = worker.apply_inputs("p4_v1")
    mesh = Mesh(shape={"data": 1}, device=torch.device("cpu"))
    got = pipeline.pipeline_apply(worker.stage_fn,
                                  {k: torch.tensor(v)
                                   for k, v in stack.items()},
                                  torch.tensor(x), mesh)
    want = jpipeline.pipeline_apply(
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), stack, x,
        _jax_mesh({"data": 1}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    stack, x, t, head = worker.f1b_inputs("p4_v1_m8_head")
    loss, dsp, dlp, dx = pipeline_1f1b.one_f_one_b(
        worker.stage_fn, worker.head_loss,
        {k: torch.tensor(v) for k, v in stack.items()}, torch.tensor(x),
        torch.tensor(t), mesh, num_microbatches=8,
        loss_params={"w": torch.tensor(head["w"])})
    jloss, jdsp, jdlp, jdx = jpipeline_1f1b.one_f_one_b(
        _jax_stage, lambda lp, y, tt: jnp.mean((y @ lp["w"] - tt) ** 2),
        stack, x, t, _jax_mesh({"data": 1}), num_microbatches=8,
        loss_params=head)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for got_g, want_g in ((dsp["w"], jdsp["w"]), (dsp["b"], jdsp["b"]),
                          (dlp["w"], jdlp["w"]), (dx, jdx)):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   rtol=1e-5, atol=1e-6)


# -- the schedules on four ranks ----------------------------------------------

def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


@pytest.mark.parametrize("case", sorted(worker.APPLY_CASES))
def test_pipeline_apply_matches_jax(ranks, case):
    """Each rank's output (replicated over the pipe group) and gradients
    of ``sum(y**2)`` equal JAX's ``pipeline_apply`` under ``jax.grad``:
    outside a step the whole stack's gradient on every rank, inside one
    this rank's chunks'; fewer microbatches than stages, and each stage
    rematerialized (``remat=True``: JAX's values without it), too."""
    axes, v, m, _ = worker.APPLY_CASES[case]
    stack, _, x = worker.apply_inputs(case)
    jmesh = _jax_mesh(axes)

    def loss(sp, xx):
        y = jpipeline.pipeline_apply(_jax_stage, sp, xx, jmesh,
                                     num_microbatches=m,
                                     num_virtual_stages=v)
        return jnp.sum(y ** 2), y

    with jax.set_mesh(jmesh):
        (grads, y) = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(
            stack, x)
    (dsp, dx), want = grads, np.asarray(y)
    s = axes["pipe"]
    for r, out in enumerate(ranks[1]):
        d = r // (4 // s)
        for where in ("out", "in"):
            prefix = f"apply/{case}/{where}"
            np.testing.assert_allclose(out[f"{prefix}/y"], want, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(out[f"{prefix}/dx"], np.asarray(dx),
                                       rtol=1e-4, atol=1e-5)
            for k in ("w", "b"):
                g = np.asarray(dsp[k])
                if where == "in":
                    g = g[d * v:(d + 1) * v]
                np.testing.assert_allclose(out[f"{prefix}/d{k}"], g,
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=(where, k))


@pytest.mark.parametrize("case", sorted(worker.F1B_CASES))
def test_one_f_one_b_matches_jax(ranks, case):
    """Each rank's loss, the whole stack's, the head's and the input's
    gradients equal JAX's ``one_f_one_b`` on the same mesh: the loss at
    rtol 1e-6, the gradients at rtol 1e-5 / atol 1e-6."""
    axes, v, m, _, with_head = worker.F1B_CASES[case]
    stack, x, t, head = worker.f1b_inputs(case)
    jmesh = _jax_mesh(axes)

    def jhead(lp, y, tt):
        return jnp.mean((y @ lp["w"] - tt) ** 2)

    def jloss(y, tt):
        return jnp.mean((y - tt) ** 2)

    kw = dict(num_microbatches=m, num_virtual_stages=v)
    with jax.set_mesh(jmesh):
        if with_head:
            loss, dsp, dlp, dx = jpipeline_1f1b.one_f_one_b(
                _jax_stage, jhead, stack, x, t, jmesh, loss_params=head,
                **kw)
        else:
            loss, dsp, dx = jpipeline_1f1b.one_f_one_b(
                _jax_stage, jloss, stack, x, t, jmesh, **kw)
    for out in ranks[1]:
        np.testing.assert_allclose(out[f"f1b/{case}/loss"], np.asarray(loss),
                                   rtol=1e-6)
        np.testing.assert_allclose(out[f"f1b/{case}/dx"], np.asarray(dx),
                                   rtol=1e-5, atol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(out[f"f1b/{case}/d{k}"],
                                       np.asarray(dsp[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        if with_head:
            np.testing.assert_allclose(out[f"f1b/{case}/dw_head"],
                                       np.asarray(dlp["w"]), rtol=1e-5,
                                       atol=1e-6)


def test_one_f_one_b_inside_a_step_takes_this_ranks_chunks(ranks):
    """Inside a step the stage leaves are this rank's ``[V, ...]`` chunks
    and so are their gradients: rank ``d``'s rows of JAX's."""
    case = "p4_v2_m8"
    axes, v, m, _, _ = worker.F1B_CASES[case]
    stack, x, t, _ = worker.f1b_inputs(case)
    jmesh = _jax_mesh(axes)
    with jax.set_mesh(jmesh):
        loss, dsp, dx = jpipeline_1f1b.one_f_one_b(
            _jax_stage, lambda y, tt: jnp.mean((y - tt) ** 2), stack, x, t,
            jmesh, num_microbatches=m, num_virtual_stages=v)
    for d, out in enumerate(ranks[1]):
        prefix = f"f1b/{case}/in"
        np.testing.assert_allclose(out[f"{prefix}/loss"], np.asarray(loss),
                                   rtol=1e-6)
        np.testing.assert_allclose(out[f"{prefix}/dx"], np.asarray(dx),
                                   rtol=1e-5, atol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(
                out[f"{prefix}/d{k}"], np.asarray(dsp[k])[d * v:(d + 1) * v],
                rtol=1e-5, atol=1e-6, err_msg=k)


# -- the pipelined LMs --------------------------------------------------------

def _jax_value_and_grad(lm, params, tokens, mesh):
    jspec = _jax_spec(lm, mesh)
    batch = {"tokens": tokens}
    with jax.set_mesh(mesh):
        if jspec.grad_fn is not None:
            loss, grads = jspec.grad_fn(params, batch)
        else:
            loss, grads = jax.value_and_grad(jspec.loss_fn)(params, batch)
    return float(loss), dict(flatten(_np(grads)))


@pytest.mark.parametrize("lm", ["lm", "moe"])
def test_pipelined_lm_loss_and_gradients_match_jax(lm_inputs, lm):
    """At one process the pipelined LM (and MoE LM) gives JAX's loss and
    every gradient under ``jax.value_and_grad`` at rtol 1e-5."""
    params, tokens = lm_inputs[lm]
    jmesh = _jax_mesh({"data": 1})
    want_loss, want = _jax_value_and_grad(lm, params, tokens, jmesh)
    spec = _one_spec(lm)
    tparams = params_from_jax(params)
    leaves = [x.requires_grad_() for _, x in flatten(tparams)]
    loss = spec.loss_fn(tparams, {"tokens": tokens})
    got = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    for (name, _), g in zip(flatten(tparams), got):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", sorted(worker.VG_CASES))
def test_pipelined_lm_on_a_pipe_mesh_matches_jax(ranks, lm_inputs, case):
    """On a pipe mesh (outside a step) every rank's loss and gradients of
    the pipelined LM through GPipe, the interleaved schedule, the 1F1B
    ``grad_fn`` (Program D's shapes) and the MoE LM over ``{"pipe": 2,
    "expert": 2}`` equal JAX's on the same mesh: the loss at rtol 1e-5,
    the gradients at rtol 1e-4 / atol 1e-5."""
    lm, axes, b = worker.VG_CASES[case]
    params, tokens = lm_inputs[lm]
    want_loss, want = _jax_value_and_grad(lm, params, tokens[:b],
                                          _jax_mesh(axes))
    for out in ranks[1]:
        np.testing.assert_allclose(float(out[f"vg/{case}/loss"]), want_loss,
                                   rtol=1e-5)
        for name, g in want.items():
            np.testing.assert_allclose(out[f"vg/{case}/g:{name}"], g,
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def _assert_stage_shards(out, prefix, lm):
    """Each rank holds ``1/S`` of every stage stack (``1/(S·X)`` of an
    expert stack) and of its two moments, and nothing else is cut."""
    axes = worker.TRAIN_RUNS[prefix.split("/")[1]][1]
    s, x = axes["pipe"], axes.get("expert", 1)
    keys = [k for k in out if k.startswith(f"{prefix}/shard:")]
    assert sorted(k.split(":", 1)[1] for k in keys) == sorted(
        n for n in out[f"{prefix}/cut"])
    assert keys and all(":stack/" in k for k in keys)
    for k in keys:
        held, full, held_m, full_m = out[k].tolist()
        n = s * (x if "/moe/w" in k else 1)
        assert (n * held, n * held_m) == (full, full_m), k


@pytest.mark.parametrize("run", sorted(worker.TRAIN_RUNS))
def test_pipe_mesh_training_matches_one_process(ranks, one_runs, run):
    """Each run on 4 ranks (GPipe on ``{"pipe": 2, "data": 2}`` under
    ``PSLoadBalancing`` and ``AllReduce`` and on ``{"pipe": 4}``; Program
    D's interleaved 1F1B through ``capture(grad_fn=)``; Program B's MoE LM
    on ``{"pipe": 2, "expert": 2}``): losses and global norms (each shard
    counted once) within 1e-5 of one process, the gathered parameters at
    atol 1e-4 (in pipeline order), the evaluation at rtol 1e-5, one
    digest and one fingerprint across ranks, each stage stack's ``1/S`` a
    rank with its moments; no stage stack is replicated."""
    losses, norms, params, ev = one_runs[run]
    lm = worker.TRAIN_RUNS[run][0]
    rows = worker.pipeline_rows(lm)
    outs = ranks[1]
    prefix = f"train/{run}"
    for out in outs:
        np.testing.assert_allclose(out[f"{prefix}/losses"], losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(out[f"{prefix}/norms"], norms, rtol=1e-5)
        for n, v in params.items():
            got = out[f"{prefix}/p:{n}"]
            if n.startswith("stack/"):
                got = got[rows]
            np.testing.assert_allclose(got, v, rtol=0, atol=1e-4, err_msg=n)
        np.testing.assert_allclose(out[f"{prefix}/eval"], ev, rtol=1e-5)
        _assert_stage_shards(out, prefix, lm)
        assert not [w for w in out["warnings"]
                    if "replicating" in w and "stack/" in w]
    for key in ("digest", "fingerprint"):
        assert len({str(o[f"{prefix}/{key}"]) for o in outs}) == 1, key


def test_pipe_mesh_checkpoint_restores_on_one_process(ranks, lm_inputs):
    """The ``{"pipe": 2, "data": 2}`` ``AllReduce`` checkpoint restores
    into a 1-process session bit for bit (the stage stacks and their
    moments gathered whole, in the stored order); its next loss is the
    4-rank run's at rtol 1e-5."""
    root, outs = ranks
    pp = outs[0]
    params, tokens = lm_inputs["lm"]
    sess = _one_session("lm", strategy.AllReduce(), params)
    assert Saver(sess).restore(Saver.latest_checkpoint(
        str(root / "pp"))) == 2
    got_p, got_o = sess.export_state()
    state = {**{f"p:{k}": v for k, v in flatten(got_p)},
             **{f"o:{k}": v for k, v in flatten(got_o)}}
    assert any(k.startswith("o:mu/stack/") for k in state)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), pp[f"ckpt/pp/{k}"],
                                      err_msg=k)
    np.testing.assert_allclose(
        float(sess.run({"tokens": tokens})["loss"]),
        float(pp["ckpt/pp/next"]), rtol=1e-5)


def test_one_process_checkpoint_restores_on_the_pipe_mesh(ranks, one_ckpt):
    """A 1-process checkpoint restores into a ``{"pipe": 2, "data": 2}``
    session: its whole logical state (the stacks and their moments cut to
    this rank's stage and gathered back) bit for bit; the next loss is
    the 1-process run's at rtol 1e-5."""
    _, state, next_loss = one_ckpt
    for out in ranks[1]:
        assert int(out["ckpt/one/step"]) == 2
        for k, v in state.items():
            np.testing.assert_array_equal(out[f"ckpt/one/{k}"], v,
                                          err_msg=k)
        np.testing.assert_allclose(out["ckpt/one/loss"], next_loss,
                                   rtol=1e-5)


# -- the compiler, the step's plan and its IR --------------------------------

def _kw(spec):
    return dict(sparse_vars=spec.sparse_vars,
                pipeline_vars=spec.pipeline_vars,
                expert_vars=spec.expert_vars)


def test_capture_flags_pipeline_vars_as_jax_does(lm_inputs):
    """``capture(pipeline_vars=, expert_vars=)``: the catalog's flags are
    JAX's, field for field; ``grad_fn`` with ``has_aux`` is JAX's
    ``ValueError``."""
    for lm in ("lm", "moe"):
        params = lm_inputs[lm][0]
        kw = _kw(_jax_spec(lm))
        want = [v.__dict__ for v in JGraphItem(params, **kw).info.variables]
        got = [v.to_dict() for v in GraphItem(params_from_jax(params),
                                              **kw).info.variables]
        for w, g in zip(want, got):
            assert g == {**w, "shape": list(w["shape"]),
                         "dtype": str(w["dtype"])}
        assert any(g["pipeline"] for g in got)
    with pytest.raises(ValueError, match="grad_fn does not support has_aux"):
        GraphItem({"w": torch.zeros(2)}, grad_fn=lambda p, b: None,
                  has_aux=True)


@pytest.mark.parametrize("mesh", sorted(PLAN_MESHES))
def test_plans_equal_the_jax_compilers(lm_inputs, mesh):
    """Every builder's plans on a pipe mesh: the structural pipe spec on
    dim 0 (and expert on dim 1 of the MoE stacks), the partition fields
    and the pads are the JAX plan's."""
    axes, lm = PLAN_MESHES[mesh]
    params = lm_inputs[lm][0]
    kw = _kw(_jax_spec(lm))
    for name in BUILDERS:
        jgi = JGraphItem(params, **kw)
        jstrat = getattr(jstrategy, name)().build(
            jgi, JResourceSpec(resource_info=ONE_NODE))
        jplans = jstrategy.StrategyCompiler(_jax_mesh(axes)).compile(
            jstrat, jgi).var_plans
        plans = StrategyCompiler(Mesh(shape=dict(axes),
                                      device=torch.device("cpu"))).compile(
            Strategy.from_dict(jstrat.to_dict()),
            GraphItem(params_from_jax(params), **kw)).var_plans
        assert plans.keys() == jplans.keys(), name
        for n, plan in plans.items():
            want = jplans[n]
            assert (plan.sync_kind, plan.param_spec, plan.opt_spec,
                    plan.pad_axis, plan.pad_dim, plan.partition_axis,
                    plan.num_shards, plan.sparse) == (
                want.sync_kind, tuple(want.param_spec),
                tuple(want.opt_spec), want.pad_axis, want.pad_dim,
                want.partition_axis, want.num_shards, want.sparse), \
                (name, n)
        stack = "stack/moe/wi" if lm == "moe" else "stack/mlp/wi/kernel"
        assert plans[stack].param_spec[0] == "pipe"


@pytest.mark.parametrize("mesh", sorted(PLAN_MESHES))
@pytest.mark.parametrize("name", IR_BUILDERS)
def test_step_ir_equals_jax_builder_on_a_pipe_mesh(lm_inputs, name, mesh,
                                                   monkeypatch):
    """The port's step IR on a pipe mesh is the JAX package's
    ``build_schedule_ir`` of the same buckets, with a per-shard leg for
    each stage stack (its signature from the JAX compiler's own plan) and
    the MoE legs of the expert-flagged catalog: equal JSON and
    fingerprint, and JAX's fused kernels.  No leg moves activations: the
    JAX package's GSPMD inserts those hops, its IR has none either."""
    monkeypatch.setenv("AUTODIST_FUSED_KERNELS", "all")
    monkeypatch.setenv("AUTODIST_FUSED_INTERPRET", "1")
    axes, lm = PLAN_MESHES[mesh]
    params = lm_inputs[lm][0]
    kw = _kw(_jax_spec(lm))
    gi = GraphItem(params_from_jax(params), optimizer=fusable_adam(1e-3),
                   numerics=NUMERICS, **kw)
    strat = getattr(strategy, name)().build(
        gi, ResourceSpec(resource_info=ONE_NODE))
    compiled = StrategyCompiler(Mesh(shape=dict(axes),
                                     device=torch.device("cpu"))).compile(
        strat, gi)
    staged = pipe_support(gi, compiled)
    assert staged and all(n.startswith("stack/") for n in staged)
    if lm == "moe":
        assert set(partition_support(gi, compiled)) == {"stack/moe/wi",
                                                        "stack/moe/wo"}
    sp = plan_step(gi, compiled)
    ir = sp.ir
    assert not sir.errors(sir.verify(ir))
    jgi = JGraphItem(params, **kw)
    jplans = jstrategy.StrategyCompiler(_jax_mesh(axes)).compile(
        jstrategy.Strategy.from_dict(strat.to_dict()), jgi).var_plans
    bucketed = {n for b in sp.buckets for n in b.names}
    per_var = [jsir.PerVarEntry(
        name=v.name, dtype=v.dtype, nbytes=v.byte_size,
        sync_kind="AllReduce", compressor=jplans[v.name].compressor,
        sig=jsir.fact_from_varplan(jplans[v.name],
                                   jgi.info.by_name(v.name)).sig(),
        stateful=jsir.compressor_stateful(jplans[v.name].compressor))
        for v in gi.info.variables if v.name not in bucketed]
    assert {e.name for e in per_var} == set(staged)
    ov = sp.overlap
    stateful_b = [b.key for b in sp.buckets
                  if jsir.compressor_stateful(b.compressor)]
    twin = jsir.build_schedule_ir(
        axes=dict(axes), accum_steps=1, buckets=_jax_buckets(sp.buckets),
        plan=joverlap.OverlapPlan(
            mode=ov.mode, pipeline=ov.pipeline, ring=ov.ring,
            one_shot_small=ov.one_shot_small, prefetch=ov.prefetch,
            ring_threshold=ov.ring_threshold, drops=ov.drops),
        per_var=per_var, guard=True,
        donated=() if any(e.stateful for e in per_var) else tuple(
            f"sync:{k}" for k in stateful_b + ["~numerics"]),
        stateful_keys=set(stateful_b), fused_kernels=sp.fused_kernels,
        moe=jsir.moe_facts_from_vars(jgi.info.variables, axes=dict(axes)))
    rs_b = [b for b in sp.buckets if b.mode == "reduce_scatter"]
    want, _ = jfk.resolve_fused(
        guard=True, has_rs=bool(rs_b), has_quant_ring=False,
        optimizer_fusable=True, adam_state_shaped=True,
        f32_buckets=all(b.dtype == "float32" for b in rs_b))
    assert sp.fused_kernels == want
    assert ir.to_json() == twin.to_json()
    assert ir.fingerprint() == twin.fingerprint()
    assert "act" not in {leg.kind for leg in ir.legs}


# -- the options around it ---------------------------------------------------

def test_grad_fn_refusals_and_loss_scale_are_jax_s(lm_inputs):
    """``capture(grad_fn=)`` with a compressor raises JAX's ``ValueError``;
    with a loss scale the scale is off, with JAX's warning (the guard
    stays on); a pipe mesh with a seq axis raises naming P10."""
    params = lm_inputs["lm"][0]
    spec = _one_spec("lm", schedule="1f1b", num_virtual_stages=1,
                     num_microbatches=None)

    def session(builder, **cap):
        _reset_default_autodist_for_testing()
        ad = AutoDist(strategy_builder=builder, device="cpu")
        with ad.scope():
            ad.capture(params=params_from_jax(params),
                       optimizer=optim.adam(1e-3), loss_fn=spec.loss_fn,
                       grad_fn=spec.grad_fn, sparse_vars=spec.sparse_vars,
                       pipeline_vars=spec.pipeline_vars, **cap)
        return ad.create_distributed_session()

    with pytest.raises(ValueError, match="cannot combine with gradient "
                                         "compressors"):
        session(strategy.AllReduce(compressor="HorovodCompressor"))
    with pytest.warns(UserWarning, match="loss scaling disabled"):
        sess = session(strategy.AllReduce(),
                       numerics={"loss_scale": 128.0})
    res = sess.run({"tokens": lm_inputs["lm"][1]})
    assert bool(res["grad_health"].all_finite)
    assert float(res["grad_health"].loss_scale) == 1.0
    from autodist_tpu_torch.kernel.graph_transformer import \
        check_seq_program
    gi = GraphItem(params_from_jax(params), loss_fn=spec.loss_fn,
                   **_kw(spec))
    with pytest.raises(NotImplementedError, match="ROADMAP: P10"):
        check_seq_program(gi, Mesh(shape={"pipe": 2, "seq": 2},
                                   device=torch.device("cpu")))


def test_convert_cuts_pipe_and_expert_shards(lm_inputs):
    """``params_from_jax(shards=)`` with a session's ``shard_cuts`` gives a
    rank's stage of each stack (and its experts of an expert stack), the
    other leaves whole."""
    params = lm_inputs["moe"][0]
    cuts = {"stack/moe/wi": ((0, 2, 1), (1, 2, 0)),
            "stack/ln_attn": ((0, 2, 0),)}
    cut = dict(flatten(params_from_jax(params, shards=cuts)))
    wi = params["stack"]["moe"]["wi"]
    np.testing.assert_array_equal(cut["stack/moe/wi"].numpy(),
                                  wi[2:, :1])
    np.testing.assert_array_equal(cut["stack/ln_attn"].numpy(),
                                  params["stack"]["ln_attn"][:2])
    assert tuple(cut["stack/moe/wo"].shape) == \
        params["stack"]["moe"]["wo"].shape


def test_pipelined_lm_1f1b_warns_without_model_axis():
    """A large tied vocab under ``schedule="1f1b"`` with no model axis
    warns (a dense replicated f32 head gradient), as JAX's factory does;
    GPipe and a model axis stay silent."""
    records = []

    class _Capture(stdlib_logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = _Capture(level=stdlib_logging.WARNING)
    logger = stdlib_logging.getLogger("autodist_tpu")
    logger.addHandler(handler)
    try:
        big = dict(vocab_size=262144, num_layers=4, num_heads=2,
                   head_dim=64, d_ff=32, max_len=16, seq_len=16)
        mesh = Mesh(shape={"pipe": 4, "data": 2}, device=torch.device("cpu"))
        pipelined_transformer_lm(mesh, schedule="1f1b", **big)
        assert any("model" in m for m in records), records
        records.clear()
        tp = Mesh(shape={"pipe": 2, "model": 2, "data": 2},
                  device=torch.device("cpu"))
        pipelined_transformer_lm(tp, schedule="1f1b", **big)
        pipelined_transformer_lm(mesh, schedule="gpipe", **big)
        assert not [m for m in records if "head gradient" in m], records
    finally:
        logger.removeHandler(handler)


@pytest.mark.parametrize("search", [True, "beam"])
def test_auto_strategy_on_a_pipe_mesh_chooses_as_jax(lm_inputs, search):
    """``AutoStrategy`` on the pipelined LM over ``{"pipe": 2, "data": 2}``
    (the resource spec's mesh hint): pipe-stacked candidates are legal,
    and the port picks the JAX package's plan and names the same
    choice."""
    params = lm_inputs["lm"][0]
    kw = _kw(_jax_spec("lm"))
    info = dict(ONE_NODE, mesh=dict(worker.PD))
    jb = jstrategy.AutoStrategy(search=search)
    pb = strategy.AutoStrategy(search=search)
    import optax
    want = jb.build(JGraphItem(params, optimizer=optax.adam(1e-3), **kw),
                    JResourceSpec(resource_info=info))
    got = pb.build(GraphItem(params_from_jax(params),
                             optimizer=optim.adam(1e-3), **kw),
                   ResourceSpec(resource_info=info))
    assert got.to_dict()["node_config"] == want.to_dict()["node_config"]
    assert pb.last_choice == jb.last_choice and pb.last_choice
