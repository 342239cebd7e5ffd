"""The port's seq mesh axis against the JAX package (CPU).

* Ring and Ulysses attention (``autodist_tpu_torch.parallel``) on 2 and 4
  gloo ranks, each holding one chunk of the sequence, against JAX's
  ``make_ring_attention`` / ``make_ulysses_attention`` on a ``{"seq": n}``
  mesh of virtual CPU devices: values at rtol/atol 2e-5, gradients of
  ``sum(out ** 2)`` at 5e-4.  The dense inner is held to JAX's dense
  inner; the flash inner (the port's plain K1–K3) to JAX's
  ``inner="flash", interpret=True``.
* Ulysses refuses a head count the axis does not divide.
* The flash plain versions at head dim 32 against the JAX kernel in
  interpret mode: outputs at 1e-5, gradients at 1e-4.
* The LM on a ``{"data": 2, "seq": 2}`` mesh of 4 gloo ranks, ring,
  Ulysses, dense and flash (gathered K/V; flash as K1 blocks merged in
  log space) against JAX's losses on the same mesh shape at rtol 1e-4;
  a loss that is not sequence-parallel raises naming P10; the schedule
  IR of a data × seq plan equals the JAX analyzer's.

The ranks run ``tests/torch_seq_worker.py`` through
``tests/torch_launch.py``, one intra-op thread each.
"""
from pathlib import Path

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_launch
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.mesh import build_mesh as jax_build_mesh
from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.parallel import make_ring_attention as jax_ring
from autodist_tpu.parallel import make_ulysses_attention as jax_ulysses
from autodist_tpu.strategy import AllReduce as JAllReduce

from autodist_tpu_torch.const import P10
from autodist_tpu_torch.mesh import Mesh
from autodist_tpu_torch.parallel import (make_ring_attention,
                                         make_ulysses_attention,
                                         sequence_parallel_attention)

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_seq_worker.py"
SEQ_SIZES = (2, 4)
IMPLS = ("ring_dense", "ring_flash", "ulysses_dense", "ulysses_flash")
LM_CFG = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=8,
              d_ff=64, max_len=32, seq_len=32)
LM_AXES = {"data": 2, "seq": 2}
#: the port's LM runs and the JAX attention each is held to
LM_RUNS = {"ring": "ring", "ring_flash": "ring", "ulysses": "ulysses",
           "dense": "dense", "flash": "dense", "ring_zero1": "ring"}


def _jflat(tree):
    """``[(name, numpy array)]`` of a JAX tree, by the port's names."""
    from autodist_tpu.graph_item import path_name

    return [(path_name(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _qkv(b=2, t=32, h=4, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return {x: rng.randn(b, t, h, d).astype(np.float32)
            for x in ("q", "k", "v")}


def _launch(tmp, world, mode, inputs):
    path = tmp / f"in-{mode}-{world}.npz"
    np.savez(path, **inputs)
    outs = [tmp / f"out-{mode}-{world}-{r}.npz" for r in range(world)]
    launch = torch_launch.Launch(
        lambda rank, init: [WORKER, rank, world, init, outs[rank], mode,
                            path], world=world, tmp_dir=tmp)
    return launch, outs


@pytest.fixture(scope="module")
def attn_runs(tmp_path_factory):
    """Each seq size's ranks, launched together: ``{size: [rank's
    results]}``."""
    tmp = tmp_path_factory.mktemp("seq_attn")
    runs = {n: _launch(tmp, n, "attn", _qkv()) for n in SEQ_SIZES}
    out = {}
    for n, (launch, outs) in runs.items():
        launch.wait(300)
        out[n] = [dict(np.load(p)) for p in outs]
    return out


def _jax_impl(name, mesh):
    kind, inner = name.split("_")
    make = jax_ring if kind == "ring" else jax_ulysses
    if inner == "dense":
        return make(mesh, inner="dense")
    return make(mesh, inner="flash", block_q=8, block_k=8, interpret=True)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("size", SEQ_SIZES)
def test_attention_matches_jax(attn_runs, size, impl, causal):
    """Each rank's chunk of the output and of dq/dk/dv, joined along the
    sequence, equals JAX's global result."""
    data = _qkv()
    q, k, v = (jnp.asarray(data[x]) for x in ("q", "k", "v"))
    fn = _jax_impl(impl, jax_build_mesh({"seq": size},
                                        devices=jax.devices()[:size]))
    want = jax.jit(lambda q, k, v: fn(q, k, v, causal))(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v, causal)
                                                     ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    key = f"{impl}/{int(causal)}"

    def joined(part):
        return np.concatenate([r[f"{key}/{part}"] for r in attn_runs[size]],
                              axis=1)
    np.testing.assert_allclose(joined("o"), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    for part, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(joined(part), np.asarray(g), rtol=5e-4,
                                   atol=5e-4, err_msg=part)


def test_ulysses_rejects_indivisible_heads():
    mesh = Mesh(shape={"seq": 8}, device=torch.device("cpu"))
    x = torch.zeros(2, 32, 4, 16)          # 4 heads, seq 8
    with pytest.raises(ValueError, match="divisible"):
        make_ulysses_attention(mesh)(x, x, x, False)


def test_outside_a_seq_step_the_functions_attend_over_whole_sequences():
    """No seq chunk (an evaluation, a mesh without the axis): the inner
    attention over the whole sequence, as JAX's dense fallback."""
    from autodist_tpu_torch.models.transformer import dense_attention

    mesh = Mesh(shape={"seq": 2}, device=torch.device("cpu"))
    data = _qkv()
    q, k, v = (torch.tensor(data[x]) for x in ("q", "k", "v"))
    want = dense_attention(q, k, v, True)
    for fn in (make_ring_attention(mesh), make_ulysses_attention(mesh),
               make_ring_attention(mesh, inner="flash")):
        assert fn.sequence_parallel
        torch.testing.assert_close(fn(q, k, v, True), want, rtol=2e-5,
                                   atol=2e-5)


def test_other_attention_functions_refuse_a_seq_axis():
    """A plain ``attn_fn`` that is neither dense nor flash has no gathered
    form: it raises naming P10 before any collective."""
    from autodist_tpu_torch.mesh import seq_chunk
    from autodist_tpu_torch.models.transformer import MultiHeadAttention

    mha = MultiHeadAttention(2, 8, causal=True,
                             attn_fn=lambda q, k, v, causal: q)
    params = mha.init(16, torch.Generator().manual_seed(0), torch.float32)
    with seq_chunk(None, 2, 0), pytest.raises(NotImplementedError,
                                              match="P10"):
        mha(params, torch.zeros(1, 4, 16))


def test_factory_and_axis_checks():
    mesh = Mesh(shape={"seq": 2}, device=torch.device("cpu"))
    from autodist_tpu_torch.models.transformer import dense_attention

    assert sequence_parallel_attention("dense", mesh) is dense_attention
    assert callable(sequence_parallel_attention("ring", mesh))
    assert callable(sequence_parallel_attention("ulysses", mesh))
    with pytest.raises(ValueError):
        sequence_parallel_attention("bogus", mesh)
    with pytest.raises(ValueError, match="inner"):
        make_ring_attention(mesh, inner="pallas")
    with pytest.raises(ValueError, match="seq"):
        make_ring_attention(mesh, axis_name="model")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_head_dim_32_matches_jax_interpret(causal):
    """K1–K3's plain versions at D = 32 (the long-context example's head
    dim) against the JAX kernel in interpret mode."""
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    jfa = importlib.import_module("autodist_tpu.ops.flash_attention")
    assert 32 in fa.HEAD_DIMS
    data = _qkv(b=2, t=48, h=2, d=32, seed=4)
    jq, jk, jv = (jnp.asarray(data[x]) for x in ("q", "k", "v"))

    def jfn(q, k, v):
        return jfa.flash_attention_with_lse(q, k, v, causal, block_q=16,
                                            block_k=16, interpret=True)
    jo, jlse = jfn(jq, jk, jv)
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v)[0] ** 2)
                      + jnp.sum(jnp.sin(jfn(q, k, v)[1])),
                      argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (torch.tensor(data[x]).requires_grad_(True)
               for x in ("q", "k", "v"))
    o, lse = fa.flash_attention_with_lse(q, k, v, causal)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               rtol=1e-5, atol=1e-5)
    ((o ** 2).sum() + torch.sin(lse).sum()).backward()
    for got, want in zip((q.grad, k.grad, v.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


# -- the LM on a data x seq mesh ---------------------------------------------

@pytest.fixture(scope="module")
def lm_inputs():
    jspec = jax_lm(**LM_CFG, attn_fn=jax_dense)
    params = jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    return params, jspec.sample_batch(8)


@pytest.fixture(scope="module")
def lm_run(tmp_path_factory, lm_inputs):
    params, batch = lm_inputs
    tmp = tmp_path_factory.mktemp("seq_lm")
    flat = {f"p:{k}": v for k, v in _jflat(params)}
    launch, outs = _launch(tmp, 4, "lm", {**flat,
                                          "tokens": batch["tokens"]})
    launch.wait(400)
    return [dict(np.load(p)) for p in outs]


def _jax_lm(params, batch, kind):
    jax_reset()
    mesh = jax_build_mesh(LM_AXES, devices=jax.devices()[:4])
    attn = {"ring": lambda: jax_ring(mesh),
            "ulysses": lambda: jax_ulysses(mesh),
            "dense": lambda: jax_dense}[kind]()
    spec = jax_lm(**LM_CFG, attn_fn=attn)
    ad = JAutoDist(strategy_builder=JAllReduce(), mesh_axes=LM_AXES)
    with ad.scope():
        ad.capture(params=params, optimizer=optax.sgd(0.1),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars)
    sess = ad.create_distributed_session(mesh=mesh)
    losses = [float(sess.run(batch)["loss"]) for _ in range(3)]
    return losses, jax.tree.map(np.asarray, sess.params)


@pytest.fixture(scope="module")
def jax_lm_runs(lm_inputs):
    params, batch = lm_inputs
    return {kind: _jax_lm(params, batch, kind)
            for kind in sorted(set(LM_RUNS.values()))}


@pytest.mark.parametrize("run", sorted(LM_RUNS))
def test_lm_on_data_seq_mesh_matches_jax(run, lm_run, jax_lm_runs):
    """Every rank reports JAX's global loss at each step and ends on JAX's
    parameters; the evaluation on whole sequences gives the same loss on
    every rank."""
    want, jparams = jax_lm_runs[LM_RUNS[run]]
    for res in lm_run:
        np.testing.assert_allclose(res[f"{run}/losses"], want, rtol=1e-4)
    evals = {float(res[f"{run}/eval"]) for res in lm_run}
    assert len(evals) == 1
    for name, value in _jflat(jparams):
        np.testing.assert_allclose(lm_run[0][f"{run}/p:{name}"], value,
                                   rtol=0, atol=1e-4, err_msg=name)
        for res in lm_run[1:]:
            np.testing.assert_array_equal(res[f"{run}/p:{name}"],
                                          lm_run[0][f"{run}/p:{name}"])
    assert len({str(res[f"{run}/fingerprint"]) for res in lm_run}) == 1


def test_data_seq_mesh_layout_and_other_models_raise(lm_run):
    """Rank ``d·2 + s`` holds data row ``d``, chunk ``s``: seq neighbours
    are adjacent ranks.  A loss that does not compute on sequence chunks
    raises naming P10."""
    for rank, res in enumerate(lm_run):
        assert res["mesh"].tolist() == [2, 2, rank // 2, rank % 2, 2, 2]
        assert str(res["other_raises"]).endswith(f"(ROADMAP: {P10})")


@pytest.mark.parametrize("builder", ["AllReduce", "Zero1"])
def test_seq_plan_ir_equals_jax_analysis_ir(builder):
    """The schedule IR the port lowers for a data × seq mesh equals the
    JAX analyzer's IR of the same strategy on that mesh (the seq axis is
    in ``axes``; neither IR has a leg for the seq sum, which GSPMD inserts
    in the JAX step)."""
    from autodist_tpu import strategy as jstrategy
    from autodist_tpu.analysis import analyzer as janalyzer
    from autodist_tpu.analysis.schedule import ir_for as jax_ir_for
    from autodist_tpu.graph_item import GraphItem as JGraphItem
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec

    from autodist_tpu_torch import optim, strategy
    from autodist_tpu_torch.graph_item import GraphItem
    from autodist_tpu_torch.kernel.graph_transformer import \
        lowered_schedule_ir
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy.compiler import StrategyCompiler

    info = {"nodes": [{"address": "localhost", "chips": 4}]}
    spec = transformer_lm(**LM_CFG)
    gi = GraphItem(spec.init(0, device="cpu"), optimizer=optim.adam(1e-3),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars)
    rs = ResourceSpec(resource_info=info)
    strat = getattr(strategy, builder)().build(gi, rs)
    mesh = Mesh(shape=dict(LM_AXES), device=torch.device("cpu"))
    compiled = StrategyCompiler(mesh, rs).compile(strat, gi)
    ir, _ = lowered_schedule_ir(gi, compiled)
    assert not sir.errors(sir.verify(ir))
    jspec = jax_lm(**LM_CFG)
    jgi = JGraphItem(jspec.init(jax.random.PRNGKey(0)),
                     optimizer=optax.adam(1e-3), loss_fn=jspec.loss_fn,
                     sparse_vars=jspec.sparse_vars)
    ctx = janalyzer.AnalysisContext(
        strategy=jstrategy.base.Strategy.from_dict(strat.to_dict()),
        graph_item=jgi, axes=dict(LM_AXES),
        resource_spec=JResourceSpec(resource_info=info))
    janalyzer._load_passes()
    janalyzer.PASS_REGISTRY["legality"](ctx)
    jir = jax_ir_for(ctx)
    assert ir.to_json() == jir.to_json()
    assert ir.fingerprint() == jir.fingerprint()
