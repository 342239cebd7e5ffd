"""The port's static analyzer against the JAX package's.

* every data-axis case of the JAX analyzer tests (built from the helpers
  of ``tests/_analysis_fixtures.py``: legality, sync coverage, memory
  budgets, precision, collectives, batch layout) and the port's zoo
  catalogs (a small TransformerLM, BERT and NCF, sparse tables included)
  under the fixed builders and ``AutoStrategy``: ``analyze()`` gives the
  same ``(rule, severity, var_name)`` set in both packages, with the JAX
  package's fused kernels on (the port's always are);
* the memory pass's per-device terms (params, gradients, optimizer state,
  sync state, activations) are equal at rtol 1e-9 for adam, adamw, sgd
  with momentum and adagrad, plain and under ``cast_opt_state``, for
  replicated, PS and ZeRO-1 plans;
* ``pipe``, ``model``, ``expert`` and ``seq`` meshes and hints give the
  JAX analyzer's findings (no axis is refused any more);
* ``preflight``, ``create_distributed_session(validate=True)`` and
  ``fit(validate=True)`` raise ``StrategyValidationError`` on an illegal
  plan before any step runs, and pass a legal one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from autodist_tpu.analysis import analyze as jax_analyze
from autodist_tpu.analysis import analyzer as janalyzer
from autodist_tpu.analysis import memory as jmemory
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.ops.opt_state_dtype import cast_opt_state as jax_cast
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy.base import Strategy as JStrategy
from autodist_tpu.strategy.base import VarConfig as JVarConfig
from autodist_tpu_torch import optim, strategy
from autodist_tpu_torch.analysis import (StrategyValidationError, analyze,
                                         analyzer, preflight)
from autodist_tpu_torch.analysis import memory
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.graph_item import GraphItem, flatten, unflatten
from autodist_tpu_torch.models.bert import bert
from autodist_tpu_torch.models.ncf import ncf
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops.opt_state_dtype import cast_opt_state
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import Strategy

from _analysis_fixtures import ar_node, full_cover, ps_node

pytestmark = pytest.mark.torch_port

AXES8 = {"data": 8}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    torch.set_num_threads(1)
    _reset_default_autodist_for_testing()
    monkeypatch.setenv("AUTODIST_FUSED_KERNELS", "all")
    monkeypatch.setenv("AUTODIST_FUSED_INTERPRET", "1")


# -- the two packages' programs from one description --------------------------

OPTIMIZERS = {
    "adam": (lambda: optax.adam(1e-3), lambda: optim.adam(1e-3)),
    "adamw": (lambda: optax.adamw(1e-3), lambda: optim.adamw(1e-3)),
    "sgd": (lambda: optax.sgd(1e-2, momentum=0.9),
            lambda: optim.sgd(1e-2, momentum=0.9)),
    "adagrad": (lambda: optax.adagrad(1e-2), lambda: optim.adagrad(1e-2)),
}


def _programs(shapes, *, optimizer="adam", cast=False, sparse=(),
              frozen=(), remat=None):
    """``(jax GraphItem, port GraphItem)`` over ``{name: (shape, dtype)}``
    zeros; names are ``/`` paths."""
    jopt, popt = OPTIMIZERS[optimizer]
    jopt, popt = jopt(), popt()
    if cast:
        jopt, popt = jax_cast(jopt), cast_opt_state(popt)
    jtree = unflatten([(n, jnp.zeros(s, jnp.dtype(d)))
                       for n, (s, d) in shapes.items()])
    ptree = unflatten([(n, torch.zeros(s, dtype=getattr(torch, d)))
                       for n, (s, d) in shapes.items()])
    kw = dict(sparse_vars=list(sparse), untrainable_vars=list(frozen))
    loss = (lambda p, b: 0.0) if remat else None
    return (JGraphItem(jtree, optimizer=jopt, remat=remat, loss_fn=loss,
                       **kw),
            GraphItem(ptree, optimizer=popt, remat=remat, loss_fn=loss,
                      **kw))


GI = {"dense/kernel": ((16, 8), "float32"), "dense/bias": ((16,), "float32"),
      "emb/table": ((96, 16), "float32")}


def _findings(report):
    return sorted({(d.rule, d.severity.name, d.var_name)
                   for d in report.diagnostics})


def _both(jstrat, jgi, pgi, **kw):
    """The two reports on the same strategy (the port's from the JAX
    strategy's JSON)."""
    pstrat = Strategy.from_dict(jstrat.to_dict())
    jkw = dict(kw)
    pkw = dict(kw)
    if "resource_spec" in kw:
        jkw["resource_spec"] = JResourceSpec(resource_info=kw["resource_spec"])
        pkw["resource_spec"] = ResourceSpec(resource_info=kw["resource_spec"])
    return jax_analyze(jstrat, jgi, **jkw), analyze(pstrat, pgi, **pkw)


CASES = {
    "legal": (GI, lambda gi: full_cover(gi), {}),
    "indivisible": ({"w": ((3, 4), "float32")},
                    lambda gi: JStrategy(node_config=[
                        ps_node("w", partitioner="3,1")]), {}),
    "padded": ({"w": ((12, 4), "float32")},
               lambda gi: JStrategy(node_config=[
                   ps_node("w", partitioner="12,1")]), {}),
    "invalid_axis": (GI, lambda gi: full_cover(
        gi, but=["dense/bias"],
        extra=[ps_node("dense/bias", partitioner="1,1,4")]), {}),
    "multi_axis": (GI, lambda gi: full_cover(
        gi, but=["dense/kernel"],
        extra=[ps_node("dense/kernel", partitioner="2,2")]), {}),
    "batch_indivisible": (GI, lambda gi: full_cover(gi), {
        "batch": {"x": np.zeros((10, 4), np.float32)}}),
    "unsynced": (GI, lambda gi: full_cover(gi, but=["dense/bias"]), {}),
    "shadowed": (GI, lambda gi: full_cover(
        gi, extra=[ar_node("dense/kernel")]), {}),
    "dead_node": (GI, lambda gi: full_cover(
        gi, extra=[ar_node("no/such/var")]), {}),
    "missing_sync": (GI, lambda gi: JStrategy(node_config=[
        ar_node(v.name) for v in gi.trainable_var_infos
        if v.name != "dense/bias"] + [JVarConfig("dense/bias")]), {}),
    "budget_over": (GI, lambda gi: full_cover(gi), {"budget_bytes": 1024}),
    "budget_spec": (GI, lambda gi: full_cover(gi), {"resource_spec": {
        "nodes": [{"address": "localhost", "chips": 8}],
        "hbm_gb": 1e-6}}),
    "bf16_wire": (GI, lambda gi: JStrategy(node_config=[
        ar_node(v.name, compressor="HorovodCompressor")
        for v in gi.trainable_var_infos]), {}),
    "unknown_compressor": (GI, lambda gi: full_cover(
        gi, but=["dense/kernel"],
        extra=[ar_node("dense/kernel", compressor="NoSuch")]), {}),
    "integer_compressed": ({"codes": ((8, 8), "int32")},
                           lambda gi: JStrategy(node_config=[
                               ar_node("codes",
                                       compressor="HorovodCompressor")]), {}),
    "powersgd_rank": (GI, lambda gi: full_cover(
        gi, but=["dense/bias"],
        extra=[ar_node("dense/bias", compressor="PowerSGDCompressor")]), {}),
    "bf16_noop": ({"w": ((8, 8), "bfloat16")},
                  lambda gi: JStrategy(node_config=[
                      ar_node("w", compressor="HorovodCompressor")]), {}),
    "sparse_compressed": (GI, lambda gi: full_cover(
        gi, but=["emb/table"],
        extra=[ar_node("emb/table", compressor="HorovodCompressorEF")]), {}),
    "partition_dropped": ({"big": ((64, 8), "float32"),
                           "small": ((8,), "float32")},
                          lambda gi: JStrategy(node_config=[
                              ps_node("big", partitioner="64,1"),
                              ar_node("small",
                                      compressor="HorovodCompressorEF")]), {}),
    "mixed_staleness": (GI, lambda gi: JStrategy(node_config=[
        ps_node("dense/kernel", staleness=2), ps_node("dense/bias"),
        ps_node("emb/table")]), {}),
    "zero1_ring": (GI, lambda gi: JStrategy(node_config=[
        ar_node(v.name, sync="reduce_scatter", overlap="ring")
        for v in gi.trainable_var_infos]), {}),
    "ring_degenerate": (GI, lambda gi: JStrategy(node_config=[
        ar_node(v.name, overlap="ring") for v in gi.trainable_var_infos]),
        {"mesh": {"data": 1}}),
    "int8_pipeline": (GI, lambda gi: JStrategy(node_config=[
        ar_node(v.name, compressor="Int8Compressor", overlap="pipeline")
        for v in gi.trainable_var_infos]), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_findings_equal_jax(case):
    shapes, build, kw = CASES[case]
    jgi, pgi = _programs(shapes, sparse=["emb/table"] if "emb/table" in shapes
                         else ())
    kw = dict(kw)
    kw.setdefault("mesh", AXES8)
    jrep, prep = _both(build(jgi), jgi, pgi, **kw)
    assert _findings(prep) == _findings(jrep)


# -- the zoo catalogs under the builders --------------------------------------

def _zoo():
    lm = transformer_lm(vocab_size=96, num_layers=2, num_heads=2,
                        head_dim=8, d_ff=32, max_len=16)
    b = bert(vocab_size=96, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
             max_len=16, seq_len=16)
    n = ncf(num_users=64, num_items=48, mf_dim=8, mlp_dims=(16, 8))
    return {"lm": lm, "bert": b, "ncf": n}


ZOO_BUILDERS = ("AllReduce", "Zero1", "PS", "PSLoadBalancing",
                "PartitionedPS", "Parallax", "AutoStrategy")


@pytest.mark.parametrize("chips", (1, 8))
@pytest.mark.parametrize("builder", ZOO_BUILDERS)
@pytest.mark.parametrize("model", ("lm", "bert", "ncf"))
def test_zoo_findings_equal_jax(model, builder, chips):
    import autodist_tpu.strategy as jstrategy

    spec = _zoo()[model]
    shapes = {n: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
              for n, x in flatten(spec.init(0, device="cpu"))}
    jgi, pgi = _programs(shapes, sparse=spec.sparse_vars)
    info = {"nodes": [{"address": "localhost", "chips": chips}],
            "hbm_gb": 80}
    jstrat = getattr(jstrategy, builder)().build(
        jgi, JResourceSpec(resource_info=info))
    pstrat = getattr(strategy, builder)().build(
        pgi, ResourceSpec(resource_info=info))
    assert pstrat.to_dict()["node_config"] == jstrat.to_dict()["node_config"]
    jrep, prep = _both(jstrat, jgi, pgi, resource_spec=info,
                       batch={"x": np.zeros((8, 16), np.int32)})
    assert _findings(prep) == _findings(jrep)


# -- the memory pass, term by term --------------------------------------------

def _ctx(mod, strat, gi, axes, batch=None):
    ctx = mod.AnalysisContext(strategy=strat, graph_item=gi, axes=axes,
                              batch=batch)
    mod._load_passes()
    mod.PASS_REGISTRY["legality"](ctx)
    return ctx


MEM_PLANS = {
    "replicated": lambda gi: full_cover(gi),
    "ps": lambda gi: JStrategy(node_config=[
        ps_node(v.name) for v in gi.trainable_var_infos]),
    "ps_partitioned": lambda gi: JStrategy(node_config=[
        ps_node("dense/kernel", partitioner="16,1"),
        ps_node("dense/bias"), ps_node("emb/table")]),
    "zero1": lambda gi: JStrategy(node_config=[
        ar_node(v.name, sync="reduce_scatter")
        for v in gi.trainable_var_infos]),
    "ef_residuals": lambda gi: JStrategy(node_config=[
        ar_node(v.name, compressor="HorovodCompressorEF")
        for v in gi.trainable_var_infos]),
    "int8_residuals": lambda gi: JStrategy(node_config=[
        ar_node(v.name, compressor="Int8Compressor")
        for v in gi.trainable_var_infos]),
}


@pytest.mark.parametrize("d", (1, 8))
@pytest.mark.parametrize("plan", sorted(MEM_PLANS))
@pytest.mark.parametrize("cast", (False, True))
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_memory_terms_equal_jax(opt, cast, plan, d):
    # a frozen variable carries no state in either package; at d 1 only:
    # the JAX package's frozen-aware state is not isomorphic to the
    # params, so it counts every slot undivided there (ROADMAP Queue 3)
    frozen = {"frozen/w": ((8, 8), "float32")} if d == 1 else {}
    jgi, pgi = _programs(dict(GI, **frozen), optimizer=opt, cast=cast,
                         sparse=["emb/table"], frozen=list(frozen),
                         remat="dots")
    jstrat = MEM_PLANS[plan](jgi)
    batch = {"x": np.zeros((16, 12), np.float32)}
    jctx = _ctx(janalyzer, jstrat, jgi, {"data": d}, batch)
    pctx = _ctx(analyzer, Strategy.from_dict(jstrat.to_dict()), pgi,
                {"data": d}, batch)
    for name in ("_opt_state_bytes", "_sync_state_bytes",
                 "_activation_bytes"):
        want = getattr(jmemory, name)(jctx)
        got = getattr(memory, name)(pctx)
        np.testing.assert_allclose(got, want, rtol=1e-9, err_msg=name)
    assert memory._param_and_grad_bytes(pctx) == pytest.approx(
        jmemory._param_and_grad_bytes(jctx), rel=1e-9)
    jrep = jax_analyze(jstrat, jgi, mesh={"data": d}, batch=batch)
    prep = analyze(Strategy.from_dict(jstrat.to_dict()), pgi,
                   mesh={"data": d}, batch=batch)
    jwm = [x.message for x in jrep.by_rule("memory/hbm-breakdown")]
    pwm = [x.message for x in prep.by_rule("memory/hbm-breakdown")]
    assert pwm == jwm
    # the watermark finding carries the terms it adds up, as JAX's are
    jterms = {"params_bytes": jmemory._param_and_grad_bytes(jctx)["params"],
              "optimizer_bytes": jmemory._opt_state_bytes(jctx) or 0.0,
              "activations_bytes": jmemory._activation_bytes(jctx) or 0.0}
    jwater = jmemory._watermark(jctx, sum(jterms.values()))
    (found,) = prep.by_rule("memory/watermark")
    assert [found.message] == [x.message
                               for x in jrep.by_rule("memory/watermark")]
    np.testing.assert_allclose(
        [found.data[k] for k in jterms] + [found.data["watermark_bytes"]],
        list(jterms.values()) + [jwater.peak_bytes], rtol=1e-9)


# -- axes the port cannot lower -----------------------------------------------

@pytest.mark.parametrize("mesh", ({"pipe": 4, "data": 2},
                                  {"model": 2, "data": 4},
                                  {"expert": 2, "data": 4}))
def test_non_data_axes_are_a_p10_error(mesh):
    """No axis is refused any more: ``pipe`` (since the pipelines),
    ``model`` and ``expert`` meshes, and hints naming them, give the JAX
    analyzer's findings, rule for rule."""
    jgi, pgi = _programs(GI)
    jstrat = full_cover(jgi)
    assert _findings(analyze(Strategy.from_dict(jstrat.to_dict()), pgi,
                             mesh=mesh)) == \
        _findings(jax_analyze(jstrat, jgi, mesh=mesh))
    (axis,) = [a for a, n in mesh.items() if a != "data"]
    jstrat.graph_config.mesh_axes = {axis: 2, "pipe": 2}
    jrep, prep = _both(jstrat, jgi, pgi, mesh=mesh)
    assert _findings(prep) == _findings(jrep)
    assert not prep.by_rule("legality/axis-not-ported")


def test_seq_axis_is_lowered_not_a_p10_error():
    """The port lowers the seq axis: a data × seq mesh and a hint naming
    every axis give the JAX analyzer's findings; no
    ``legality/axis-not-ported`` is left."""
    jgi, pgi = _programs(GI)
    jstrat = full_cover(jgi)
    jrep, prep = _both(jstrat, jgi, pgi, mesh={"data": 4, "seq": 2})
    assert _findings(prep) == _findings(jrep)
    jstrat.graph_config.mesh_axes = {"seq": 2, "model": 2, "expert": 2,
                                     "pipe": 2}
    jrep, prep = _both(jstrat, jgi, pgi, mesh=AXES8)
    assert _findings(prep) == _findings(jrep)
    assert not prep.by_rule("legality/axis-not-ported")


# -- the validate hooks --------------------------------------------------------

def _facade(builder, **capture):
    spec = transformer_lm(vocab_size=97, num_layers=2, num_heads=2,
                          head_dim=8, d_ff=32, max_len=16)
    ad = AutoDist(strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"),
                   optimizer=optim.adam(1e-3), loss_fn=spec.loss_fn,
                   **capture)
    return spec, ad


class _Illegal(strategy.StrategyBuilder):
    """Every variable but the first covered: an unsynced trainable."""

    def build(self, graph_item, resource_spec):
        st = strategy.AllReduce().build(graph_item, resource_spec)
        st.node_config = st.node_config[1:]
        return st


def test_preflight_raises_with_the_report():
    jgi, pgi = _programs(GI)
    with pytest.raises(StrategyValidationError) as e:
        preflight(Strategy.from_dict(
            full_cover(jgi, but=["dense/bias"]).to_dict()), pgi, mesh=AXES8)
    assert [d.rule for d in e.value.report.errors] == [
        "sync/unsynced-trainable"]


def test_session_validate_raises_before_any_step(monkeypatch):
    _, ad = _facade(_Illegal())
    with pytest.raises(StrategyValidationError):
        ad.create_distributed_session(validate=True)
    _reset_default_autodist_for_testing()
    monkeypatch.setenv("AUTODIST_VALIDATE", "1")
    _, ad = _facade(_Illegal())
    with pytest.raises(StrategyValidationError):
        ad.create_distributed_session()


def test_fit_validate_raises_before_training():
    spec, ad = _facade(_Illegal())
    sess = ad.create_distributed_session()
    with pytest.raises(StrategyValidationError):
        sess.fit(spec.sample_batch(4), epochs=1, steps_per_epoch=1,
                 validate=True)
    assert sess.step_count == 0


def test_legal_session_validates_and_trains():
    spec, ad = _facade(strategy.Zero1(), numerics={"clip_norm": 1.0})
    sess = ad.create_distributed_session(validate=True)
    hist = sess.fit(spec.sample_batch(4), epochs=1, steps_per_epoch=2,
                    validate=True)
    assert sess.step_count == 2 and np.isfinite(hist.history["loss"]).all()
