"""The port's ``model`` mesh axis against the JAX package.

* ``build_mesh`` over ``{"data": 2, "model": 2}`` and ``{"model": 2,
  "seq": 2}`` on 4 gloo ranks: the ranks of a model group are adjacent
  (the expert and pipe axes' layouts are ``tests/test_torch_moe.py``'s
  and ``tests/test_torch_pipeline.py``'s);
* the compiler's plans on a model mesh equal the JAX compiler's
  ``VarPlan`` layouts for all 8 builders (``param_spec``, ``opt_spec``,
  the pad, the partition fields), with a padded and a "more than
  doubling" partition;
* the bucketed step's schedule IR on a model mesh equals the JAX
  package's ``build_schedule_ir`` on the same buckets, its per-variable
  legs taken from the JAX compiler's own plans: JSON and fingerprint;
* the analyzer's findings and memory terms equal JAX's on a model mesh;
* on 4 gloo ranks (one launch of ``tests/torch_model_worker.py``):
  ``PartitionedPS`` and ``PartitionedAR`` on ``{"data": 2, "model": 2}``
  train as the JAX session on the same mesh (losses and global norms at
  rtol 1e-5, gathered parameters at atol 1e-4) while each rank holds half
  of every model-sharded parameter and of its moments; Program A's twin
  (``{"model": 2, "seq": 2}``, ring attention) at rtol 1e-4 of JAX's;
  Program E's partitioned leg at rtol 1e-4 of JAX's same leg (losses,
  parameters; its error-feedback residuals at atol 1e-6) and of the
  replicated compressed run, with its parameters still split over ``model``;
  ``make_flash_attention(mesh)`` equal to the call without a mesh,
  gradients too, and local inside a step; a model-mesh checkpoint
  restored on one process bit for bit, and the reverse; a RAM snapshot
  with model-sharded compressor state restored bit for bit; a wrongly
  shaped moment of a model-sharded variable refused on import.

Torch runs one intra-op thread; JAX runs its CPU devices (Pallas, where
reached, in interpret mode).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu.strategy as jstrategy
from autodist_tpu.analysis import analyzer as janalyzer
from autodist_tpu.analysis import analyze as jax_analyze
from autodist_tpu.analysis import memory as jmemory
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.kernel.synchronization import bucketing as jbucketing
from autodist_tpu.kernel.synchronization import overlap as joverlap
from autodist_tpu.kernel.synchronization import schedule_ir as jsir
from autodist_tpu.mesh import build_mesh as jax_build_mesh
from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.ops import fused_kernels as jfk
from autodist_tpu.ops.fused_kernels import fusable_adam as jax_fusable_adam
from autodist_tpu.parallel import make_ring_attention as jax_ring
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy.base import Strategy as JStrategy
from autodist_tpu_torch import optim, strategy
from autodist_tpu_torch.analysis import analyze, analyzer, memory
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.checkpoint.saver import _unpack_layout, read_item
from autodist_tpu_torch.convert import params_from_jax, params_to_numpy
from autodist_tpu_torch.graph_item import GraphItem, flatten
from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
from autodist_tpu_torch.kernel.synchronization.explicit_sync import (
    partition_support, plan_step)
from autodist_tpu_torch.mesh import Mesh, build_mesh
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops.fused_kernels import fusable_adam
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import StrategyCompiler
from autodist_tpu_torch.strategy.base import Strategy

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_launch  # noqa: E402
import torch_dp_worker as dp_worker  # noqa: E402
import torch_model_worker as worker  # noqa: E402
from _analysis_fixtures import ar_node, ps_node  # noqa: E402

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_model_worker.py"
BUILDERS = ("PS", "PSLoadBalancing", "PartitionedPS", "UnevenPartitionedPS",
            "AllReduce", "PartitionedAR", "RandomAxisPartitionAR",
            "Parallax")
MESHES = ({"data": 2, "model": 2}, {"data": 2, "model": 4})
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


@pytest.fixture(scope="module")
def lm_inputs():
    """The LM's weights (the port's init from seed 0, as numpy) and the
    batch both packages train on."""
    spec = transformer_lm(**worker.LM_CFG)
    return (params_to_numpy(spec.init(0, device="cpu")),
            spec.sample_batch(8, seed=1))


@pytest.fixture(scope="module")
def a_inputs():
    """Program A's weights (JAX's init) and batch."""
    jspec = jax_lm(**worker.A_CFG, attn_fn=jax_dense)
    return (jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(0))),
            jspec.sample_batch(4))


def _one_process_session(builder, params):
    _reset_default_autodist_for_testing()
    spec = transformer_lm(**worker.LM_CFG)
    ad = AutoDist(strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params),
                   optimizer=fusable_adam(1e-2), loss_fn=spec.loss_fn,
                   sparse_vars=spec.sparse_vars, numerics=NUMERICS)
    return ad.create_distributed_session()


@pytest.fixture(scope="module")
def one_ckpt(tmp_path_factory, lm_inputs):
    """A 1-process ``PartitionedAR`` checkpoint after 2 steps, its logical
    state and its next loss."""
    params, batch = lm_inputs
    root = tmp_path_factory.mktemp("model_axis")
    sess = _one_process_session(strategy.PartitionedAR(), params)
    for _ in range(2):
        sess.run(batch)
    Saver(sess).save(str(root / "one"), step=2)
    p, o = sess.export_state()
    state = {**{f"p:{k}": v.numpy() for k, v in flatten(p)},
             **{f"o:{k}": v.numpy() for k, v in flatten(o)}}
    return root, state, float(sess.run(batch)["loss"])


@pytest.fixture(scope="module")
def ranks(one_ckpt, lm_inputs, a_inputs):
    """One launch of 4 gloo ranks: every rank's outputs."""
    root, _, _ = one_ckpt
    params, batch = lm_inputs
    aparams, abatch = a_inputs
    rng = np.random.RandomState(7)
    qkv = {x: rng.randn(2, 16, 8, 8).astype(np.float32)
           for x in ("q", "k", "v")}
    inp = root / "in.npz"
    np.savez(inp, **{f"p:{k}": v for k, v in flatten(params)},
             **{f"a:{k}": v.numpy() for k, v in
                flatten(params_from_jax(aparams))},
             tokens=batch["tokens"], a_tokens=abatch["tokens"], **qkv)
    torch_launch.run(
        lambda rank, init: [WORKER, rank, 4, init, root / f"rank{rank}.npz",
                            inp, root],
        world=4, tmp_dir=root, timeout=400)
    return root, qkv, [dict(np.load(root / f"rank{r}.npz"))
                       for r in range(4)]


# -- the mesh ---------------------------------------------------------------

def test_mesh_layout_on_four_ranks(ranks):
    """Rank ``d·2 + m`` on ``{"data": 2, "model": 2}`` and ``s·2 + m`` on
    ``{"model": 2, "seq": 2}``: a model group is two adjacent ranks."""
    for rank, out in enumerate(ranks[2]):
        assert out["mesh/model"].tolist() == [2, 2, rank // 2, rank % 2,
                                              2, 2]
        assert out["mesh/seq"].tolist() == [2, 2, rank % 2, rank // 2,
                                            2, 2]


@pytest.mark.parametrize("axis", ["pipe"])
def test_pipe_and_expert_still_raise_naming_p10(axis):
    """Both axes build now (``tests/test_torch_pipeline.py`` and
    ``tests/test_torch_moe.py`` train on them): on this one-process world
    a size of 2 does not divide the world, and a size of 1 builds."""
    with pytest.raises(ValueError, match="divide the world size"):
        build_mesh({axis: 2, "model": 1}, device="cpu")
    mesh = build_mesh({axis: 1, "model": 1}, device="cpu")
    assert mesh.model_size == mesh.pipe_size == 1


# -- the compiler -----------------------------------------------------------

def _catalogs(lm_params):
    """The LM (vocab 97: an odd dim that pads) and a small catalog with a
    dim that pads and one whose pad would double it."""
    small = {"w": np.zeros((6, 4), np.float32),
             "tiny": np.zeros((2, 8), np.float32),
             "emb": np.zeros((10, 4), np.float32)}
    return {"lm": (lm_params, {"sparse_vars": ("embed",)}),
            "small": (small, {"sparse_vars": ("emb",)})}


def _small_strategy(kind):
    def node(name, partitioner=""):
        if kind == "ps":
            return ps_node(name, partitioner=partitioner)
        n = ar_node(name)
        n.partitioner = partitioner
        return n
    return JStrategy(node_config=[node("w", partitioner="6,1"),
                                  node("tiny", partitioner="2,1"),
                                  node("emb")])


def _both_plans(jstrat, params, kw, axes):
    pgi = GraphItem(params_from_jax(params), **kw)
    plans = StrategyCompiler(Mesh(shape=dict(axes),
                                  device=torch.device("cpu"))).compile(
        Strategy.from_dict(jstrat.to_dict()), pgi).var_plans
    jplans = jstrategy.StrategyCompiler(_jax_mesh(axes)).compile(
        jstrat, JGraphItem(params, **kw)).var_plans
    return plans, jplans


def _strategies(lm_params):
    out = []
    for name in BUILDERS:
        jgi = JGraphItem(lm_params, sparse_vars=("embed",))
        out.append((f"lm-{name}", "lm", getattr(jstrategy, name)().build(
            jgi, JResourceSpec(resource_info=ONE_NODE))))
    out += [("small-ps", "small", _small_strategy("ps")),
            ("small-ar", "small", _small_strategy("ar"))]
    return out


@pytest.mark.parametrize("axes", MESHES, ids=["dp2tp2", "dp2tp4"])
def test_plans_equal_the_jax_compilers(lm_inputs, axes):
    """Every plan's layouts and partition fields are the JAX plan's; the
    padded ``w`` keeps its pad, ``tiny`` (2 rows over 4) stays
    replicated."""
    cats = _catalogs(lm_inputs[0])
    for label, cat, jstrat in _strategies(lm_inputs[0]):
        params, kw = cats[cat]
        plans, jplans = _both_plans(jstrat, params, kw, axes)
        assert plans.keys() == jplans.keys(), label
        for n, plan in plans.items():
            want = jplans[n]
            assert (plan.sync_kind, plan.param_spec, plan.opt_spec,
                    plan.pad_axis, plan.pad_dim, plan.partition_axis,
                    plan.num_shards, plan.sparse) == (
                want.sync_kind, tuple(want.param_spec),
                tuple(want.opt_spec), want.pad_axis, want.pad_dim,
                want.partition_axis, want.num_shards, want.sparse), \
                (label, n)
        if cat == "small" and axes["model"] == 4:
            assert plans["w"].pad_dim == 8 and plans["tiny"].param_spec == ()


def test_padded_and_data_shardings_are_dropped_with_the_jax_warning():
    """On the bucketed step a padded model sharding is replicated with the
    JAX package's warning; an unpadded one is kept."""
    params = {"w": np.zeros((6, 4), np.float32),
              "v": np.zeros((8, 4), np.float32)}
    jstrat = JStrategy(node_config=[ps_node("w", partitioner="6,1"),
                                    ps_node("v", partitioner="8,1")])
    gi = GraphItem(params_from_jax(params))
    compiled = StrategyCompiler(Mesh(shape={"data": 1, "model": 4},
                                     device=torch.device("cpu"))).compile(
        Strategy.from_dict(jstrat.to_dict()), gi)
    with pytest.warns(UserWarning, match=r"replicating w \(pad-to-divisible"):
        part = partition_support(gi, compiled, warn=True)
    assert part == {"v": ("model", 0, 4)}


# -- the schedule IR ----------------------------------------------------------

def _jax_buckets(buckets):
    return [jbucketing.Bucket(
        key=b.key, mode=b.mode, dtype=b.dtype, compressor=b.compressor,
        group=b.group, vars=tuple(jbucketing.BucketVar(
            name=v.name, shape=tuple(v.shape), offset=v.offset)
            for v in b.vars),
        total=b.total, padded_total=b.padded_total, order=b.order)
        for b in buckets]


IR_PLANS = {**{b: (b, {}) for b in BUILDERS},
            "PartitionedAR-HorovodEF": (
                "PartitionedAR", {"compressor": "HorovodCompressorEF"})}


@pytest.mark.parametrize("axes", MESHES, ids=["dp2tp2", "dp2tp4"])
@pytest.mark.parametrize("name", sorted(IR_PLANS))
def test_step_ir_equals_jax_builder_on_a_model_mesh(name, axes, monkeypatch):
    """The port's step IR on a model mesh is the JAX package's
    ``build_schedule_ir`` of the same buckets, with a per-variable leg for
    each model-sharded variable whose signature the JAX compiler's own
    plan gives: equal JSON and fingerprint, and JAX's fused kernels."""
    monkeypatch.setenv("AUTODIST_FUSED_KERNELS", "all")
    monkeypatch.setenv("AUTODIST_FUSED_INTERPRET", "1")
    builder, kwargs = IR_PLANS[name]
    spec = transformer_lm(**worker.LM_CFG)
    gi = GraphItem(spec.init(0, device="cpu"), optimizer=fusable_adam(1e-3),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   numerics=NUMERICS)
    strat = getattr(strategy, builder)(**kwargs).build(
        gi, ResourceSpec(resource_info=ONE_NODE))
    compiled = StrategyCompiler(Mesh(shape=dict(axes),
                                     device=torch.device("cpu"))).compile(
        strat, gi)
    part = partition_support(gi, compiled)
    sp = plan_step(gi, compiled)
    ir = sp.ir
    assert not sir.errors(sir.verify(ir))
    jgi = JGraphItem(params_to_numpy(gi.params), sparse_vars=("embed",))
    jplans = jstrategy.StrategyCompiler(_jax_mesh(axes)).compile(
        jstrategy.Strategy.from_dict(strat.to_dict()), jgi).var_plans
    bucketed = {n for b in sp.buckets for n in b.names}
    per_var = []
    for v in gi.info.variables:
        if v.name in bucketed:
            continue
        stateful = jsir.compressor_stateful(jplans[v.name].compressor)
        per_var.append(jsir.PerVarEntry(
            name=v.name, dtype=v.dtype, nbytes=v.byte_size,
            sync_kind="AllReduce", compressor=jplans[v.name].compressor,
            sig=jsir.fact_from_varplan(jplans[v.name],
                                       jgi.info.by_name(v.name)).sig(),
            stateful=stateful))
    assert {e.name for e in per_var} == set(part)
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
        stateful_keys=set(stateful_b), fused_kernels=sp.fused_kernels)
    rs_b = [b for b in sp.buckets if b.mode == "reduce_scatter"]
    want, _ = jfk.resolve_fused(
        guard=True, has_rs=bool(rs_b), has_quant_ring=False,
        optimizer_fusable=True, adam_state_shaped=True,
        f32_buckets=all(b.dtype == "float32" for b in rs_b))
    assert sp.fused_kernels == want
    assert ir.to_json() == twin.to_json()
    assert ir.fingerprint() == twin.fingerprint()


# -- the analyzer ---------------------------------------------------------------

def _findings(report):
    return sorted({(d.rule, d.severity.name, d.var_name)
                   for d in report.diagnostics})


@pytest.mark.parametrize("name", BUILDERS)
def test_analyzer_rows_equal_jax_on_a_model_mesh(lm_inputs, name):
    """Legality, precision, memory and every other pass give the JAX
    package's findings for the builder's strategy on ``{"data": 2,
    "model": 2}``; the memory terms (model-sharded parameters and
    moments at 1/2) are JAX's."""
    params = lm_inputs[0]
    axes = {"data": 2, "model": 2}
    jgi = JGraphItem(params, optimizer=optax.adam(1e-3),
                     sparse_vars=("embed",))
    pgi = GraphItem(params_from_jax(params), optimizer=optim.adam(1e-3),
                    sparse_vars=("embed",))
    jstrat = getattr(jstrategy, name)().build(
        jgi, JResourceSpec(resource_info=ONE_NODE))
    pstrat = Strategy.from_dict(jstrat.to_dict())
    batch = {"tokens": np.zeros((8, 16), np.int32)}
    jrep = jax_analyze(jstrat, jgi, mesh=axes, batch=batch)
    prep = analyze(pstrat, pgi, mesh=axes, batch=batch)
    assert _findings(prep) == _findings(jrep)
    assert not prep.by_rule("legality/axis-not-ported")
    jctx = janalyzer.AnalysisContext(strategy=jstrat, graph_item=jgi,
                                     axes=axes, batch=batch)
    pctx = analyzer.AnalysisContext(strategy=pstrat, graph_item=pgi,
                                    axes=axes, batch=batch)
    for mod, ctx in ((janalyzer, jctx), (analyzer, pctx)):
        mod._load_passes()
        mod.PASS_REGISTRY["legality"](ctx)
    np.testing.assert_allclose(memory._opt_state_bytes(pctx),
                               jmemory._opt_state_bytes(jctx), rtol=1e-9)
    assert memory._param_and_grad_bytes(pctx) == pytest.approx(
        jmemory._param_and_grad_bytes(jctx), rel=1e-9)
    compiled = StrategyCompiler(Mesh(shape=axes, device=torch.device(
        "cpu"))).compile(pstrat, pgi)
    assert not analyze(compiled, pgi).errors


# -- training on 4 gloo ranks -----------------------------------------------------

def _jax_lm_run(params, batch, name):
    jax_reset()
    mesh = _jax_mesh(worker.MODEL_AXES)
    jspec = jax_lm(**worker.LM_CFG, attn_fn=jax_dense)
    ad = JAutoDist(strategy_builder=getattr(jstrategy, name)(),
                   mesh_axes=worker.MODEL_AXES)
    with ad.scope():
        ad.capture(params=params, optimizer=jax_fusable_adam(1e-2),
                   loss_fn=jspec.loss_fn, sparse_vars=jspec.sparse_vars,
                   numerics=NUMERICS)
    sess = ad.create_distributed_session(mesh=mesh)
    outs = [sess.run(batch) for _ in range(worker.STEPS)]
    return ([float(o["loss"]) for o in outs],
            [float(o["grad_health"].global_norm) for o in outs],
            jax.tree.map(np.asarray, sess.params))


@pytest.fixture(scope="module")
def jax_lm_runs(lm_inputs):
    params, batch = lm_inputs
    return {name: _jax_lm_run(params, batch, name)
            for name in worker.LM_BUILDERS}


def _assert_params(out, prefix, want, atol=1e-4):
    for name, value in flatten(params_from_jax(want)):
        np.testing.assert_allclose(out[f"{prefix}/p:{name}"], value.numpy(),
                                   rtol=0, atol=atol, err_msg=name)


def _assert_half(out, prefix):
    """Each rank holds half of every model-sharded parameter and of its
    two moments."""
    keys = [k for k in out if k.startswith(f"{prefix}/shard:")]
    assert keys
    for k in keys:
        held, full, held_m, full_m = out[k].tolist()
        assert (2 * held, 2 * held_m) == (full, full_m), k


@pytest.mark.parametrize("name", worker.LM_BUILDERS)
def test_partitioned_builders_match_jax_on_data_model_mesh(ranks,
                                                           jax_lm_runs,
                                                           name):
    """Losses and global norms (the guard's Σx², each shard counted once)
    at rtol 1e-5 of the JAX session on the same mesh, gathered
    parameters at atol 1e-4, the same on every rank; half of each
    model-sharded parameter and moment a rank; one fingerprint."""
    losses, norms, jparams = jax_lm_runs[name]
    outs = ranks[2]
    for out in outs:
        np.testing.assert_allclose(out[f"lm/{name}/losses"], losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(out[f"lm/{name}/norms"], norms,
                                   rtol=1e-5)
        _assert_params(out, f"lm/{name}", jparams)
        _assert_half(out, f"lm/{name}")
        assert not [w for w in out["warnings"] if "replicating" in w
                    and "/kernel" in w]
    assert len({str(o[f"lm/{name}/fingerprint"]) for o in outs}) == 1
    ranks_of = {tuple(o[k].tolist()[2:]) for o in outs for k in o
                if k.startswith(f"lm/{name}/rank:")}
    assert ranks_of == {(0,), (1,)}


def test_program_a_twin_matches_jax(ranks, a_inputs):
    """``PartitionedPS`` on ``{"model": 2, "seq": 2}`` with ring attention
    (Program A at data 1) at rtol 1e-4 of the JAX session's losses, the
    parameters at atol 1e-4; half of each sharded variable a rank."""
    params, batch = a_inputs
    jax_reset()
    mesh = _jax_mesh(worker.SEQ_AXES)
    jspec = jax_lm(**worker.A_CFG, attn_fn=jax_ring(mesh))
    ad = JAutoDist(strategy_builder=jstrategy.PartitionedPS(),
                   mesh_axes=worker.SEQ_AXES)
    with ad.scope():
        ad.capture(params=params, optimizer=optax.adamw(1e-3),
                   loss_fn=jspec.loss_fn, sparse_vars=jspec.sparse_vars)
    sess = ad.create_distributed_session(mesh=mesh)
    want = [float(sess.run(batch)["loss"]) for _ in range(worker.STEPS)]
    jparams = jax.tree.map(np.asarray, sess.params)
    for out in ranks[2]:
        np.testing.assert_allclose(out["progA/losses"], want, rtol=1e-4)
        _assert_params(out, "progA", jparams)
        _assert_half(out, "progA")


def _jax_prog_e_loss(p, b):
    return jnp.mean((jnp.tanh(b["x"] @ p["w1"]) @ p["w2"] + p["b"]
                     - b["y"]) ** 2)


def test_program_e_partitioned_leg(ranks):
    """``PartitionedAR(chunk_size=1, compressor="HorovodCompressorEF")``
    on ``{"data": 2, "model": 2}`` against the JAX package's same leg
    (``__graft_entry__.py:289-310``) on the same inputs and mesh: losses
    and gathered parameters at rtol 1e-4, the logical error-feedback
    residuals at atol 1e-6; within rtol 1e-4 of the port's replicated
    compressed run; its parameters and residuals stay split over
    ``model``."""
    params, _, batch = dp_worker.prog_e_problem(4)
    jax_reset()
    ad = JAutoDist(strategy_builder=jstrategy.PartitionedAR(
        chunk_size=1, compressor="HorovodCompressorEF"),
        mesh_axes=worker.MODEL_AXES)
    with ad.scope():
        ad.capture(params=jax.tree.map(jnp.asarray, params),
                   optimizer=optax.sgd(0.1), loss_fn=_jax_prog_e_loss)
    sess = ad.create_distributed_session(
        mesh=_jax_mesh(worker.MODEL_AXES))
    want = [float(sess.run(batch)["loss"]) for _ in range(5)]
    jparams = {k: np.asarray(v) for k, v in sess.params.items()}
    residuals = {k: np.asarray(sess.sync_state[k]) for k in jparams}
    assert all(r.shape == (2,) + jparams[k].shape
               for k, r in residuals.items())
    assert any(np.abs(r).max() > 0 for r in residuals.values())
    for out in ranks[2]:
        np.testing.assert_allclose(out["progE/partitioned/losses"], want,
                                   rtol=1e-4)
        for k in jparams:
            np.testing.assert_allclose(out[f"progE/partitioned/p:{k}"],
                                       jparams[k], rtol=1e-4, err_msg=k)
            # a residual is the gradient less its bf16 cast: it carries the
            # gradient's absolute rounding error (~1e-7 here), while a lost
            # or mis-sliced residual misses by its own size (~4e-4)
            np.testing.assert_allclose(out[f"progE/partitioned/ef:{k}"],
                                       residuals[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(out["progE/partitioned/losses"],
                                   out["progE/replicated/losses"],
                                   rtol=1e-4)
        held = set(out["progE/partitioned/held"].tolist())
        assert held == {"b:(2,)", "w1:(4, 16)", "w2:(8, 4)"}
        assert set(out["progE/replicated/held"].tolist()) == {
            "b:(4,)", "w1:(8, 16)", "w2:(16, 4)"}
        sync = set(out["progE/partitioned/sync"].tolist())
        assert {"b:(2,)", "w1:(4, 16)", "w2:(8, 4)"} <= sync


def test_program_e_snapshot_restores_model_shards(ranks):
    """A RAM snapshot (``checkpoint.tiers``) of Program E's partitioned
    run, its error-feedback residuals model-sharded, restores into a
    fresh session on the mesh: the logical state, the logical sync state
    and this rank's own sync state bit for bit, and the same next loss."""
    for out in ranks[2]:
        assert out["progE/snapshot/same"].tolist() == [True] * 3
        a, b = out["progE/snapshot/next"].tolist()
        assert a == b


def test_wrongly_shaped_moment_is_refused_naming_its_variable(ranks):
    """A moment of a model-sharded variable that is neither its logical
    shape nor this rank's shard raises a ValueError naming the variable
    (as a parameter does) instead of being kept as it is."""
    for out in ranks[2]:
        name, _, msg = str(out["bad_moment"]).partition("|")
        assert name and msg.startswith(f"{name}: optimizer slot of shape")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_over_the_model_axis_equals_the_unsharded_call(ranks, causal):
    """``make_flash_attention(mesh)`` on ``{"model": 4}`` (2 of 8 heads a
    rank): the output and dq, dk, dv equal the call without a mesh on
    every rank; inside ``manual_axes`` it runs on the full heads."""
    for out in ranks[2]:
        for x in ("o", "dq", "dk", "dv"):
            np.testing.assert_array_equal(
                out[f"flash/mesh/{int(causal)}/{x}"],
                out[f"flash/plain/{int(causal)}/{x}"], err_msg=x)
        np.testing.assert_array_equal(out[f"flash/local/{int(causal)}/o"],
                                      out[f"flash/plain/{int(causal)}/o"])


def test_flash_wrapper_runs_locally_inside_the_step(ranks):
    """As the LM's attention on ``{"data": 2, "model": 2}`` the wrapper
    trains bit for bit as ``flash_attention`` (local inside the step), and
    the evaluation outside a step, over the heads, agrees."""
    for out in ranks[2]:
        np.testing.assert_array_equal(out["flash_step/mesh/losses"],
                                      out["flash_step/plain/losses"])
        np.testing.assert_allclose(out["flash_step/mesh/eval"],
                                   out["flash_step/plain/eval"], rtol=1e-6)


def test_model_mesh_checkpoint_restores_on_one_process(ranks, jax_lm_runs,
                                                       lm_inputs):
    """The ``{"data": 2, "model": 2}`` ``PartitionedPS`` checkpoint
    restores into a 1-process session bit for bit: parameters, and every
    moment (the model-sharded ones gathered, the ZeRO-1 buckets cut per
    variable); its next loss is the 4-rank run's third."""
    root, _, outs = ranks
    tp = outs[0]
    sess = _one_process_session(strategy.PartitionedAR(), lm_inputs[0])
    path = Saver.latest_checkpoint(str(root / "tp"))
    assert Saver(sess).restore(path) == 2
    params, opt = sess.export_state()
    for name, value in flatten(params):
        np.testing.assert_array_equal(value.numpy(), tp[f"ckpt/tp/p:{name}"],
                                      err_msg=name)
    saved = read_item(path, "opt_state")
    want = dict(flatten(_unpack_layout(
        saved, Saver.read_meta(path)["zero1_buckets"])))
    got = dict(flatten(opt))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      want[name].numpy(), err_msg=name)
    for k in tp:
        if k.startswith("ckpt/tp/o:vars/mu/"):
            n = k[len("ckpt/tp/o:vars/mu/"):]
            np.testing.assert_array_equal(got[f"mu/{n}"].numpy(), tp[k])
    np.testing.assert_allclose(float(sess.run(lm_inputs[1])["loss"]),
                               outs[0]["lm/PartitionedPS/losses"][2],
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["PartitionedPS", "PartitionedAR"])
def test_one_process_checkpoint_restores_on_the_model_mesh(ranks, one_ckpt,
                                                           name):
    """A 1-process checkpoint restores into a ``{"data": 2, "model": 2}``
    session: its logical state is the 1-process session's bit for bit
    (moments packed into its ZeRO-1 buckets or cut to model shards and
    gathered back), and its next loss is the 1-process run's."""
    _, state, next_loss = one_ckpt
    for out in ranks[2]:
        assert int(out[f"ckpt/one/{name}/step"]) == 2
        prefix = f"ckpt/one/{name}/"
        for k, v in state.items():
            if k.startswith("p:"):
                np.testing.assert_array_equal(out[prefix + k], v,
                                              err_msg=k)
        if name == "PartitionedAR":
            for k, v in state.items():
                np.testing.assert_array_equal(out[prefix + k], v,
                                              err_msg=k)
        np.testing.assert_allclose(out[prefix + "loss"], next_loss,
                                   rtol=1e-5)
