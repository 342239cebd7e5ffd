"""The port's expert axis and MoE against the JAX package.

* ``_top2_dispatch``'s invariants, and its dispatch, combine and aux equal
  to JAX's; ``moe_ffn`` and its gradients against JAX at rtol 1e-5 (the
  JAX weights carried by ``convert.params_from_jax``); the env knob the
  wire shares with the IR; the capacity warning once with "75%";
* ``moe_transformer_lm`` at the JAX test's size: the loss and every
  gradient against ``jax.value_and_grad`` at rtol 1e-5;
* the compiler's plans on ``{"data": 2, "expert": 2}`` and ``{"expert":
  2, "model": 2}`` equal the JAX compiler's for every builder; the
  bucketed step's schedule IR (with its MoE dispatch/combine legs) equals
  the JAX package's ``build_schedule_ir``: JSON and fingerprint; the
  analyzer's findings and memory terms equal JAX's;
* on 4 gloo ranks (one launch of ``tests/torch_moe_worker.py``): the
  expert mesh's layout; ``moe_ffn`` over ``{"expert": 4}`` and ``{"data":
  2, "expert": 2}`` with this rank's experts (and with all of them) equal
  to the one-process call, gradients too, at rtol/atol 1e-5 (aux rtol
  1e-6); the int8 wire's exact construction bit for bit, its generic run
  within 0.05 of its own f32 run, its gradient against ``jax.grad``
  through JAX's ``quantize_blocks``; the MoE LM trained by
  ``PSLoadBalancing`` and ``Parallax`` on ``{"data": 2, "expert": 2}`` and
  ``PartitionedPS`` on ``{"expert": 2, "model": 2}``: losses and global
  norms within 1e-5 of one process, one digest, half of every ``wi``/
  ``wo`` and of its moments a rank; an expert-mesh checkpoint restored on
  one process bit for bit, and the reverse.

The JAX package's generic int8 case is not an oracle here (its own test
of it fails on some hosts): the port's generic int8 run is held to its
own f32 run at the JAX test's 0.05.  Torch runs one intra-op thread.
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
from autodist_tpu.analysis import analyze as jax_analyze
from autodist_tpu.analysis import analyzer as janalyzer
from autodist_tpu.analysis import memory as jmemory
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.kernel.synchronization import overlap as joverlap
from autodist_tpu.kernel.synchronization import quant_ring as jquant
from autodist_tpu.kernel.synchronization import schedule_ir as jsir
from autodist_tpu.mesh import build_mesh as jax_build_mesh
from autodist_tpu.models.moe_lm import moe_transformer_lm as jax_moe_lm
from autodist_tpu.ops import fused_kernels as jfk
from autodist_tpu.parallel import moe as jmoe
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import optim, strategy
from autodist_tpu_torch.analysis import analyze, analyzer, memory
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.convert import params_from_jax, params_to_numpy
from autodist_tpu_torch.graph_item import GraphItem, flatten
from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
from autodist_tpu_torch.kernel.synchronization.explicit_sync import (
    partition_support, plan_step)
from autodist_tpu_torch.mesh import Mesh
from autodist_tpu_torch.models import moe_transformer_lm
from autodist_tpu_torch.ops.fused_kernels import fusable_adam
from autodist_tpu_torch.parallel import moe
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import StrategyCompiler
from autodist_tpu_torch.strategy.base import Strategy

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_launch  # noqa: E402
import torch_moe_worker as worker  # noqa: E402
from test_torch_model_axis import _jax_buckets  # noqa: E402

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_moe_worker.py"
BUILDERS = ("PS", "PSLoadBalancing", "PartitionedPS", "UnevenPartitionedPS",
            "AllReduce", "PartitionedAR", "RandomAxisPartitionAR",
            "Parallax", "Zero1")
MESHES = (worker.AXES_DE, worker.AXES_EM)
MESH_IDS = ["dp2ep2", "ep2tp2"]
ONE_NODE = {"nodes": [{"address": "localhost", "chips": 4}]}
NUMERICS = {"clip_norm": worker.CLIP}
#: the FFN cases' shape: G groups of S tokens, width M, F, E experts
FFN = dict(g=4, s=16, m=8, f=32, e=4)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    monkeypatch.delenv("AUTODIST_MOE_WIRE", raising=False)
    _reset_default_autodist_for_testing()


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_build_mesh(axes, devices=jax.devices()[:n])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ffn_inputs():
    """The FFN's JAX weights, input and output weights; the int8 exact
    construction (``tests/test_moe.py``); the wire case's tensor."""
    g, s, m, f, e = (FFN[k] for k in "gsmfe")
    rng = np.random.default_rng(2)
    params = _np(jmoe.init_moe_params(jax.random.PRNGKey(1), m, f, e))
    x = rng.standard_normal((g, s, m)).astype(np.float32)
    w = rng.standard_normal((g, s, m)).astype(np.float32)
    em = 256
    exact = {"router": rng.standard_normal((em, e)).astype(np.float32),
             "wi": np.broadcast_to(np.eye(em, dtype=np.float32),
                                   (e, em, em)).copy()}
    exact["wo"] = exact["wi"].copy()
    ex = rng.integers(-126, 127, size=(g, 8, em)).astype(np.float32)
    ex[:, :, 0] = 127.0
    # the wire case: [E, G, C, M] with C·M a multiple of 256 (JAX's grid)
    wire_t = rng.standard_normal((e, g, 2, 128)).astype(np.float32)
    wire_w = rng.standard_normal((e, g, 2, 128)).astype(np.float32)
    return params, x, w, exact, ex, wire_t, wire_w


@pytest.fixture(scope="module")
def lm_inputs():
    """The MoE LM's JAX weights (threefry init) and its batch."""
    jspec = jax_moe_lm(None, **worker.LM_CFG)
    return _np(jspec.init(jax.random.PRNGKey(0))), jspec.sample_batch(8)


def _one_process_session(builder, params):
    _reset_default_autodist_for_testing()
    spec = moe_transformer_lm(None, **worker.LM_CFG)
    ad = AutoDist(strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params),
                   optimizer=fusable_adam(1e-2), loss_fn=spec.loss_fn,
                   sparse_vars=spec.sparse_vars,
                   expert_vars=spec.expert_vars, numerics=NUMERICS)
    return ad.create_distributed_session()


@pytest.fixture(scope="module")
def one_runs(lm_inputs):
    """Each LM builder's 1-process run: losses, global norms, params,
    the evaluation after the steps."""
    params, batch = lm_inputs
    out = {}
    for name, _ in worker.LM_RUNS:
        sess = _one_process_session(getattr(strategy, name)(), params)
        res = [sess.run(batch) for _ in range(worker.STEPS)]
        out[name] = ([float(r["loss"]) for r in res],
                     [float(r["grad_health"].global_norm) for r in res],
                     sess.params, float(sess.evaluate(batch)["loss"]))
    return out


@pytest.fixture(scope="module")
def one_ckpt(tmp_path_factory, lm_inputs):
    """A 1-process ``AllReduce`` checkpoint after 2 steps (no ZeRO-1
    bucket, whose membership would differ from the expert mesh's: the
    stacks leave the buckets there), its logical state and next loss."""
    params, batch = lm_inputs
    root = tmp_path_factory.mktemp("moe")
    sess = _one_process_session(strategy.AllReduce(), params)
    for _ in range(2):
        sess.run(batch)
    Saver(sess).save(str(root / "one"), step=2)
    p, o = sess.export_state()
    state = {**{f"p:{k}": v.numpy() for k, v in flatten(p)},
             **{f"o:{k}": v.numpy() for k, v in flatten(o)}}
    return root, state, float(sess.run(batch)["loss"])


@pytest.fixture(scope="module")
def ranks(one_ckpt, lm_inputs, ffn_inputs):
    """One launch of 4 gloo ranks: every rank's outputs."""
    root, _, _ = one_ckpt
    params, batch = lm_inputs
    fparams, x, w, exact, ex, wire_t, wire_w = ffn_inputs
    inp = root / "in.npz"
    np.savez(inp, **{f"p:{k}": v for k, v in flatten(params)},
             **{f"ffn:{k}": v for k, v in fparams.items()},
             **{f"exact:{k}": v for k, v in exact.items()},
             tokens=batch["tokens"], ffn_x=x, ffn_w=w, exact_x=ex,
             wire_t=wire_t, wire_w=wire_w)
    torch_launch.run(
        lambda rank, init: [WORKER, rank, 4, init, root / f"rank{rank}.npz",
                            inp, root],
        world=4, tmp_dir=root, timeout=400)
    return root, [dict(np.load(root / f"rank{r}.npz")) for r in range(4)]


# -- the mesh -----------------------------------------------------------------

def test_expert_mesh_layout_on_four_ranks(ranks):
    """``build_mesh`` accepts ``expert`` in JAX's order (pipe, data,
    expert, seq, model): rank ``d·2 + x`` on ``{"data": 2, "expert": 2}``,
    ``x·2 + m`` on ``{"expert": 2, "model": 2}`` (a model group stays
    innermost), rank ``x`` on ``{"expert": 4}``."""
    for rank, out in enumerate(ranks[1]):
        assert out["mesh/de"].tolist() == [2, 2, 1, rank // 2, rank % 2, 0,
                                           2]
        assert out["mesh/em"].tolist() == [1, 2, 2, 0, rank // 2, rank % 2,
                                           2]
        assert out["mesh/e4"].tolist() == [1, 4, 1, 0, rank, 0, 4]


def test_capture_flags_expert_vars_as_jax_does(lm_inputs):
    """``expert_vars`` matches names exact, by path prefix or glob, as the
    JAX catalog does, and so does ``pipeline_vars`` (ported since)."""
    params = lm_inputs[0]
    for pats in (("*/moe/wi", "*/moe/wo"), ("layers_0/moe/wi",),
                 ("layers_1/moe",)):
        for flag in ("expert", "pipeline"):
            kw = {f"{flag}_vars": pats}
            want = {v.name for v in JGraphItem(params, **kw)
                    .info.variables if getattr(v, flag)}
            got = {v.name for v in GraphItem(params_from_jax(params),
                                             **kw).info.variables
                   if getattr(v, flag)}
            assert got == want and got


# -- the FFN against JAX ------------------------------------------------------

def test_dispatch_invariants_and_jax_parity():
    """Each token in at most 2 slots with weights summing to <= 1, no slot
    used twice, aux > 0; dispatch, combine and aux equal JAX's (ties take
    the first expert in both), and the single-expert branch books one
    slot a token."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 16, 4)).astype(np.float32)
    jp = jax.nn.softmax(jnp.asarray(logits))
    probs = torch.softmax(torch.tensor(logits), -1)
    for cap in (8, 3):
        dispatch, combine, aux = moe._top2_dispatch(probs, cap)
        assert tuple(dispatch.shape) == (2, 16, 4, cap)
        assert float(combine.sum((2, 3)).max()) <= 1.0 + 1e-5
        assert int(dispatch.int().sum((2, 3)).max()) <= 2
        assert int(dispatch.int().sum(1).max()) <= 1
        assert float(aux) > 0.0
        jd, jc, ja = jmoe._top2_dispatch(jp, cap)
        np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
        np.testing.assert_allclose(combine.numpy(), np.asarray(jc),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(aux), float(ja), rtol=1e-6)
    tie = torch.full((1, 4, 3), 1.0 / 3)
    d, _, _ = moe._top2_dispatch(tie, 4)
    jd, _, _ = jmoe._top2_dispatch(jnp.full((1, 4, 3), 1.0 / 3), 4)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    one = torch.ones((1, 4, 1))
    d, c, _ = moe._top2_dispatch(one, 4)
    assert int(d.int().sum()) == 4 and float(c.sum()) == 4.0


@pytest.mark.parametrize("cf", [2.0, 0.5, 4.0])
def test_moe_ffn_matches_jax(ffn_inputs, cf):
    """``y``, aux and the gradients of ``sum(y · w) + aux`` (x, router,
    wi, wo) at rtol 1e-5 of JAX's, dropping capacity included."""
    params, x, w, *_ = ffn_inputs

    def jloss(p, xx):
        y, aux = jmoe.moe_ffn(p, xx, capacity_factor=cf)
        return jnp.sum(y * w) + aux, (y, aux)
    (_, (jy, jaux)), (jg, jdx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_jax(params).items()}
    xt = torch.tensor(x).requires_grad_(True)
    y, aux = moe.moe_ffn(leaves, xt, capacity_factor=cf)
    ((y * torch.tensor(w)).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    for k, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_init_moe_params_shapes():
    """The router f32 whatever ``dtype``; the stacks lead with E."""
    p = moe.init_moe_params(0, 8, 16, 4, dtype=torch.bfloat16, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        "router": ((8, 4), torch.float32),
        "wi": ((4, 8, 16), torch.bfloat16),
        "wo": ((4, 16, 8), torch.bfloat16)}


def test_moe_wire_env_knob_shared_with_ir(monkeypatch):
    """``AUTODIST_MOE_WIRE=int8`` flips the runtime wire and the IR facts'
    compressor through the same knob, as in the JAX package."""
    monkeypatch.delenv("AUTODIST_MOE_WIRE", raising=False)
    assert moe.moe_wire_format(None) is None
    assert sir.moe_wire_compressor_default() == "NoneCompressor"
    assert jmoe.moe_wire_format(None) is None
    monkeypatch.setenv("AUTODIST_MOE_WIRE", "int8")
    fmt = moe.moe_wire_format(None)
    assert fmt is not None and fmt.name == "int8"
    assert sir.moe_wire_compressor_default() == "Int8Compressor"
    assert jmoe.moe_wire_format(None).name == fmt.name
    assert moe.moe_wire_format("NoneCompressor") is None
    with pytest.raises(ValueError, match="no quantized wire format"):
        moe.moe_wire_format("HorovodCompressor")
    quant = sir.MoEFact(key="l0/moe", groups=2, seq=1024, d_model=64,
                        num_experts=8, compressor="Int8Compressor")
    jquant_fact = jsir.MoEFact(key="l0/moe", groups=2, seq=1024, d_model=64,
                               num_experts=8, compressor="Int8Compressor")
    assert quant.leg_nbytes(4) == jquant_fact.leg_nbytes(4)


def test_runtime_capacity_overflow_warns(monkeypatch):
    """An under-provisioned capacity_factor logs the shared rule's verdict
    once per config ("75%" dropped), and none when provisioned."""
    hits = []
    monkeypatch.setattr(moe.logging, "warning",
                        lambda msg, *a, **k: hits.append(msg % a))
    params = moe.init_moe_params(4, 8, 16, 4, device="cpu")
    x = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(9))
    moe._warned_capacity.clear()
    moe.moe_ffn(params, x, capacity_factor=0.5)
    moe.moe_ffn(params, x, capacity_factor=0.5)
    overflow = [m for m in hits if "moe/capacity-overflow" in m]
    assert len(overflow) == 1 and "75%" in overflow[0]
    hits.clear()
    moe._warned_capacity.clear()
    moe.moe_ffn(params, x, capacity_factor=2.0)
    assert not [m for m in hits if "moe/capacity-overflow" in m]


# -- the MoE LM against JAX ---------------------------------------------------

def test_moe_lm_loss_and_gradients_match_jax(lm_inputs):
    """The port's MoE LM on JAX's weights: the loss (cross entropy plus the
    weighted aux) and every gradient at rtol 1e-5 of
    ``jax.value_and_grad``; the logits of ``apply_fn`` too."""
    params, batch = lm_inputs
    jspec = jax_moe_lm(None, **worker.LM_CFG)
    jv, jg = jax.value_and_grad(jspec.loss_fn)(
        jax.tree.map(jnp.asarray, params), batch)
    spec = moe_transformer_lm(None, **worker.LM_CFG)
    assert spec.expert_vars == jspec.expert_vars
    assert spec.config == jspec.config
    tp = params_from_jax(params)
    for _, v in flatten(tp):
        v.requires_grad_(True)
    loss = spec.loss_fn(tp, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    want = dict(flatten(params_from_jax(_np(jg))))
    assert {n for n, _ in flatten(tp)} == set(want)
    for n, v in flatten(tp):
        np.testing.assert_allclose(v.grad.numpy(), want[n].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    np.testing.assert_allclose(
        spec.apply_fn(tp, batch["tokens"]).detach().numpy(),
        np.asarray(jspec.apply_fn(params, batch["tokens"])),
        rtol=1e-5, atol=1e-5)


def test_init_tree_equals_jax_names_and_shapes(lm_inputs):
    params = lm_inputs[0]
    tp = moe_transformer_lm(None, **worker.LM_CFG).init(0, device="cpu")
    assert [(n, tuple(v.shape), str(v.dtype)) for n, v in flatten(tp)] == \
        [(n, tuple(v.shape), str(v.dtype)) for n, v in
         flatten(params_from_jax(params))]


def test_moe_lm_on_seq_still_raises_naming_p10(lm_inputs):
    """A loss that does not compute on sequence chunks may not train on
    ``seq``: the MoE LM's raises naming P10 before any step."""
    from autodist_tpu_torch.kernel.graph_transformer import \
        check_seq_program

    spec = moe_transformer_lm(None, **worker.LM_CFG)
    gi = GraphItem(params_from_jax(lm_inputs[0]), loss_fn=spec.loss_fn)
    with pytest.raises(NotImplementedError, match="ROADMAP: P10"):
        check_seq_program(gi, Mesh(shape={"seq": 2},
                                   device=torch.device("cpu")))


# -- plans, IR and analyzer ---------------------------------------------------

def _kw(spec):
    return dict(sparse_vars=spec.sparse_vars, expert_vars=spec.expert_vars)


@pytest.mark.parametrize("axes", MESHES, ids=MESH_IDS)
def test_plans_equal_the_jax_compilers(lm_inputs, axes):
    """Every builder's plans on an expert mesh: the structural expert spec
    (after the partition under AllReduce, before the WUS fill under PS),
    the partition fields and the pads are the JAX plan's."""
    params = lm_inputs[0]
    kw = _kw(jax_moe_lm(None, **worker.LM_CFG))
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
        assert plans["layers_0/moe/wi"].param_spec[0] == "expert"


IR_BUILDERS = ("PSLoadBalancing", "Parallax", "PartitionedPS", "AllReduce",
               "Zero1")


@pytest.mark.parametrize("axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", IR_BUILDERS)
def test_step_ir_equals_jax_builder_on_an_expert_mesh(lm_inputs, name, axes,
                                                      monkeypatch):
    """The port's step IR on an expert mesh is the JAX package's
    ``build_schedule_ir`` of the same buckets, with a per-shard leg for
    each expert-sharded stack (its signature from the JAX compiler's own
    plan) and the MoE dispatch/combine legs from the expert-flagged
    catalog: equal JSON and fingerprint."""
    monkeypatch.setenv("AUTODIST_FUSED_KERNELS", "all")
    monkeypatch.setenv("AUTODIST_FUSED_INTERPRET", "1")
    params = lm_inputs[0]
    kw = _kw(jax_moe_lm(None, **worker.LM_CFG))
    gi = GraphItem(params_from_jax(params), optimizer=fusable_adam(1e-3),
                   numerics=NUMERICS, **kw)
    strat = getattr(strategy, name)().build(
        gi, ResourceSpec(resource_info=ONE_NODE))
    compiled = StrategyCompiler(Mesh(shape=dict(axes),
                                     device=torch.device("cpu"))).compile(
        strat, gi)
    part = partition_support(gi, compiled)
    assert {"layers_0/moe/wi", "layers_1/moe/wo"} <= set(part)
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
        stateful_keys=set(stateful_b), fused_kernels=sp.fused_kernels,
        moe=jsir.moe_facts_from_vars(jgi.info.variables, axes=dict(axes)))
    assert sir.MOE_ROLE_DISPATCH in ir.to_json()
    rs_b = [b for b in sp.buckets if b.mode == "reduce_scatter"]
    want, _ = jfk.resolve_fused(
        guard=True, has_rs=bool(rs_b), has_quant_ring=False,
        optimizer_fusable=True, adam_state_shaped=True,
        f32_buckets=all(b.dtype == "float32" for b in rs_b))
    assert sp.fused_kernels == want
    assert ir.to_json() == twin.to_json()
    assert ir.fingerprint() == twin.fingerprint()


def _rows(mod, ctx):
    """Every pass's findings on ``ctx``, as ``analyze`` runs them."""
    mod._load_passes()
    return sorted({(d.rule, d.severity.name, d.var_name)
                   for name in mod.PASS_ORDER
                   for d in mod.PASS_REGISTRY[name](ctx)})


@pytest.mark.parametrize("name", BUILDERS[:-1])
def test_analyzer_rows_equal_jax_on_an_expert_mesh(lm_inputs, name):
    """Every pass's findings (the ``moe/capacity-overflow`` rows too, at an
    under-provisioned capacity) and the memory terms (expert stacks and
    their moments at 1/X) equal JAX's on ``{"data": 2, "expert": 2}``;
    no ``legality/axis-not-ported``, and the compiled plans analyze
    clean."""
    params = lm_inputs[0]
    axes = dict(worker.AXES_DE)
    kw = _kw(jax_moe_lm(None, **worker.LM_CFG))
    jgi = JGraphItem(params, optimizer=optax.adam(1e-3), **kw)
    pgi = GraphItem(params_from_jax(params), optimizer=optim.adam(1e-3),
                    **kw)
    jstrat = getattr(jstrategy, name)().build(
        jgi, JResourceSpec(resource_info=ONE_NODE))
    pstrat = Strategy.from_dict(jstrat.to_dict())
    batch = {"tokens": np.zeros((8, 16), np.int32)}
    rows = {}
    for cf in (None, 0.5):
        ctxs = []
        for mod, strat, gi in ((janalyzer, jstrat, jgi),
                               (analyzer, pstrat, pgi)):
            ctx = mod.AnalysisContext(strategy=strat, graph_item=gi,
                                      axes=axes, batch=batch)
            if cf is not None:
                ctx.moe_capacity_factor = cf
            ctxs.append(ctx)
            rows[mod] = _rows(mod, ctx)
        assert rows[analyzer] == rows[janalyzer], cf
        assert not [r for r in rows[analyzer]
                    if r[0] == "legality/axis-not-ported"]
        overflow = [r for r in rows[analyzer]
                    if r[0] == sir.RULE_CAPACITY_OVERFLOW]
        assert bool(overflow) == (cf is not None)
    jctx, pctx = ctxs
    np.testing.assert_allclose(memory._opt_state_bytes(pctx),
                               jmemory._opt_state_bytes(jctx), rtol=1e-9)
    assert memory._param_and_grad_bytes(pctx) == pytest.approx(
        jmemory._param_and_grad_bytes(jctx), rel=1e-9)
    assert sorted({(d.rule, d.var_name) for d in analyze(
        pstrat, pgi, mesh=axes, batch=batch).diagnostics}) == sorted(
        {(d.rule, d.var_name) for d in jax_analyze(
            jstrat, jgi, mesh=axes, batch=batch).diagnostics})
    compiled = StrategyCompiler(Mesh(shape=axes, device=torch.device(
        "cpu"))).compile(pstrat, pgi)
    assert not analyze(compiled, pgi).errors


# -- 4 gloo ranks -------------------------------------------------------------

def _one_ffn(params, x, w, **kw):
    leaves = {k: torch.tensor(v).requires_grad_(True)
              for k, v in params.items()}
    xt = torch.tensor(x).requires_grad_(True)
    y, aux = moe.moe_ffn(leaves, xt, **kw)
    ((y * torch.tensor(w)).sum() + aux).backward()
    return {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
            "dx": xt.grad.numpy(),
            **{f"d{k}": v.grad.numpy() for k, v in leaves.items()}}


@pytest.mark.parametrize("label,n", [("e4", 4), ("de", 2)])
def test_expert_sharded_matches_unsharded(ranks, ffn_inputs, label, n):
    """``moe_ffn(mesh=)`` outside a step with this rank's ``E/X`` experts,
    and with all of them: ``y`` and the gradients of x, the router and
    this rank's experts at rtol/atol 1e-5 of the one-process call, aux at
    rtol 1e-6, on every rank."""
    params, x, w, *_ = ffn_inputs
    want = _one_ffn(params, x, w)
    for rank, out in enumerate(ranks[1]):
        r = rank % n if label == "e4" else rank % 2
        for kind in ("shard", "whole"):
            got = {k: out[f"ffn/{label}/{kind}/{k}"] for k in want}
            for k in ("y", "dx", "drouter"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-5, err_msg=(kind, k))
            np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6)
            for k in ("dwi", "dwo"):
                mine = np.split(want[k], n)[r] if kind == "shard" \
                    else want[k]
                np.testing.assert_allclose(got[k], mine, rtol=1e-5,
                                           atol=1e-5, err_msg=(kind, k))


@pytest.mark.parametrize("label", ["e4", "de"])
def test_int8_wire_exact_dequant_parity(ranks, label):
    """Grid-exact inputs (d_model 256, identity experts and activation,
    every block's amax pinned to 127) cross the int8 all-to-all bit for
    bit: the quantized run equals the f32 run exactly."""
    for out in ranks[1]:
        for k in ("y", "aux"):
            np.testing.assert_array_equal(out[f"exact/{label}/int8/{k}"],
                                          out[f"exact/{label}/none/{k}"])


@pytest.mark.parametrize("label", ["e4", "de"])
def test_int8_wire_stays_close_on_generic_inputs(ranks, label):
    """Off-grid inputs pay only per-block int8 rounding across the two
    boundaries: within 0.05 of the port's own f32 run (the JAX test's
    tolerance), and not equal to it (the wire ran)."""
    for out in ranks[1]:
        f32 = out[f"generic/{label}/none/y"]
        q = out[f"generic/{label}/int8/y"]
        np.testing.assert_allclose(q, f32, rtol=0.05, atol=0.05)
        assert not np.array_equal(q, f32)


def test_int8_wire_gradient_matches_jax_grad(ranks, ffn_inputs):
    """The int8 all-to-all's output and gradient against ``jax.grad``
    through JAX's ``quantize_blocks``/``dequantize_blocks`` of the whole
    ``[E, G, C, M]`` tensor (``C·M`` a multiple of 256: JAX's grid is
    each chunk's): no gradient through the payload, all of it through the
    scales, exactly as autodiff gives it."""
    *_, wire_t, wire_w = ffn_inputs
    fmt = jquant.wire_format_of("Int8Compressor")

    def wire(t):
        q, scales, _ = jquant.quantize_blocks(t.reshape(-1), fmt)
        return jquant.dequantize_blocks(q, scales).reshape(t.shape)
    out_full = np.asarray(wire(jnp.asarray(wire_t)))
    grad = np.asarray(jax.grad(lambda t: jnp.sum(wire(t) * wire_w))(
        jnp.asarray(wire_t)))
    assert np.abs(grad).max() > 0
    n = 4
    for r, out in enumerate(ranks[1]):
        want_out = np.split(out_full, n, axis=0)[r]
        np.testing.assert_allclose(out["wire/out"], want_out, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(out["wire/grad"],
                                   np.split(grad, n, axis=1)[r], rtol=1e-5,
                                   atol=1e-7)


def _assert_half(out, prefix):
    """Each rank holds half of every expert stack and of its two moments
    (and half of each model-sharded variable on the model mesh)."""
    keys = [k for k in out if k.startswith(f"{prefix}/shard:")]
    assert any("/moe/wi" in k for k in keys) and \
        any("/moe/wo" in k for k in keys)
    for k in keys:
        held, full, held_m, full_m = out[k].tolist()
        assert (2 * held, 2 * held_m) == (full, full_m), k


@pytest.mark.parametrize("name", [n for n, _ in worker.LM_RUNS])
def test_expert_mesh_training_matches_one_process(ranks, one_runs, name):
    """The MoE LM on 4 ranks (``PSLoadBalancing``, ``Parallax`` on
    ``{"data": 2, "expert": 2}``, ``PartitionedPS`` on ``{"expert": 2,
    "model": 2}``): losses and global norms (each shard counted once)
    within 1e-5 of one process, gathered parameters at atol 1e-4 (the
    model axis's tolerance: Adam at lr 1e-2 moves a weight by ~lr where
    its moments are near zero, so a last-bit gradient difference can
    show at 1e-5 after three steps), one
    digest and one fingerprint across ranks, the evaluation over the
    expert group at rtol 1e-5; each rank holds half of every ``wi``/``wo``
    and of its moments, its own half."""
    losses, norms, params, ev = one_runs[name]
    outs = ranks[1]
    prefix = f"lm/{name}"
    for out in outs:
        np.testing.assert_allclose(out[f"{prefix}/losses"], losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(out[f"{prefix}/norms"], norms, rtol=1e-5)
        for n, v in flatten(params):
            np.testing.assert_allclose(out[f"{prefix}/p:{n}"], v, rtol=0,
                                       atol=1e-4, err_msg=n)
        np.testing.assert_allclose(out[f"{prefix}/eval"], ev, rtol=1e-5)
        _assert_half(out, prefix)
        assert not [w for w in out["warnings"]
                    if "replicating" in w and "/moe/" in w]
    for key in ("digest", "fingerprint"):
        assert len({str(o[f"{prefix}/{key}"]) for o in outs}) == 1, key
    ranks_of = {(k, tuple(o[k].tolist()[2:])) for o in outs for k in o
                if k.startswith(f"{prefix}/rank:layers_0/moe/wi")}
    assert {r for _, r in ranks_of} == {(0,), (1,)}


def test_expert_mesh_checkpoint_restores_on_one_process(ranks, lm_inputs):
    """The ``{"data": 2, "expert": 2}`` ``PSLoadBalancing`` checkpoint
    restores into a 1-process ``AllReduce`` session bit for bit: the
    parameters, and the expert stacks' moments gathered whole; its next
    loss is the 4-rank run's at rtol 1e-5."""
    root, outs = ranks
    ep = outs[0]
    sess = _one_process_session(strategy.AllReduce(), lm_inputs[0])
    assert Saver(sess).restore(Saver.latest_checkpoint(
        str(root / "ep"))) == 2
    params, opt = sess.export_state()
    for name, value in flatten(params):
        np.testing.assert_array_equal(value.numpy(), ep[f"ckpt/ep/p:{name}"],
                                      err_msg=name)
    got = dict(flatten(opt))
    moments = [k for k in ep if k.startswith("ckpt/ep/o:vars/")
               and "/moe/w" in k]
    assert len(moments) == 8
    for k in moments:
        np.testing.assert_array_equal(
            got[k[len("ckpt/ep/o:vars/"):]].numpy(), ep[k], err_msg=k)
    np.testing.assert_allclose(float(sess.run(lm_inputs[1])["loss"]),
                               float(ep["ckpt/ep/next"]), rtol=1e-5)


@pytest.mark.parametrize("name", worker.RESTORE_INTO)
def test_one_process_checkpoint_restores_on_the_expert_mesh(ranks,
                                                            one_ckpt, name):
    """A 1-process checkpoint restores into a ``{"data": 2, "expert":
    2}`` session: the parameters (expert stacks cut to this rank's experts
    and gathered back) bit for bit, the whole logical state so under
    ``AllReduce`` (the same layout) and the expert stacks' moments under
    ``PSLoadBalancing``; the next loss is the 1-process run's at rtol
    1e-5."""
    _, state, next_loss = one_ckpt
    prefix = f"ckpt/one/{name}/"
    for out in ranks[1]:
        assert int(out[prefix + "step"]) == 2
        for k, v in state.items():
            if name == "AllReduce" or k.startswith("p:"):
                np.testing.assert_array_equal(out[prefix + k], v,
                                              err_msg=k)
            elif "/moe/w" in k:
                np.testing.assert_array_equal(
                    out[prefix + "o:vars/" + k[2:]], v, err_msg=k)
        np.testing.assert_allclose(out[prefix + "loss"], next_loss,
                                   rtol=1e-5)


def test_convert_cuts_expert_shards(lm_inputs):
    """``params_from_jax(shards=)`` gives a rank's experts of each stack
    (what the session holds), the other leaves whole."""
    params = lm_inputs[0]
    shards = {"layers_0/moe/wi": (0, 2, 1), "layers_1/moe/wo": (0, 2, 0)}
    cut = dict(flatten(params_from_jax(params, shards=shards)))
    np.testing.assert_array_equal(cut["layers_0/moe/wi"].numpy(),
                                  params["layers_0"]["moe"]["wi"][2:])
    np.testing.assert_array_equal(cut["layers_1/moe/wo"].numpy(),
                                  params["layers_1"]["moe"]["wo"][:2])
    assert cut["layers_0/moe/wo"].shape[0] == 4
    back = params_to_numpy(params_from_jax(params))
    np.testing.assert_array_equal(back["layers_0"]["moe"]["router"],
                                  params["layers_0"]["moe"]["router"])


@pytest.mark.parametrize("search", [True, "beam"])
def test_auto_strategy_on_an_expert_mesh_chooses_as_jax(lm_inputs, search):
    """``AutoStrategy`` on the MoE LM over ``{"data": 2, "expert": 2}``
    (the resource spec's mesh hint): expert-parallel candidates are legal
    and priced from their MoE legs, and the port picks the JAX package's
    plan and names the same choice."""
    params = lm_inputs[0]
    kw = _kw(jax_moe_lm(None, **worker.LM_CFG))
    info = dict(ONE_NODE, mesh=dict(worker.AXES_DE))
    jb = jstrategy.AutoStrategy(search=search)
    pb = strategy.AutoStrategy(search=search)
    want = jb.build(JGraphItem(params, optimizer=optax.adam(1e-3), **kw),
                    JResourceSpec(resource_info=info))
    got = pb.build(GraphItem(params_from_jax(params),
                             optimizer=optim.adam(1e-3), **kw),
                   ResourceSpec(resource_info=info))
    assert got.to_dict()["node_config"] == want.to_dict()["node_config"]
    assert pb.last_choice == jb.last_choice and pb.last_choice
