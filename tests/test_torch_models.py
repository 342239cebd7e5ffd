"""The port's BASELINE model families against the JAX package on the CPU.

* parity on the JAX init's weights (``convert.params_from_jax``) and a
  numpy batch: logits, loss and every gradient at rtol 1e-5 / atol 1e-5 —
  ResNet (the JAX ``ResNet`` with ``stage_sizes (1, 2, 1, 1)``, 8 classes,
  32x32: the stride-2 SAME pads, projection and identity residuals) with
  both stems, VGG16 at 64x64 (a 2x2x512 last feature map, where ``fc1``'s
  NHWC flatten order shows), BERT at the JAX test's TINY, lm1b with the
  chunked loss (4 chunks, 2 layers) and with ``sampled_softmax=16`` on the
  JAX draw's negatives, NCF at 64 users, 32 items, ``mf_dim`` 8 and MLP
  ``(32, 16, 8)``, DenseNet121 at full depth on 32x32 (the asymmetric SAME
  pads of ``conv_init`` and the max pool, every transition, a 1x1 last
  map) and InceptionV3 at its full structure on 75x75, the smallest input
  that reaches ``mixed10`` (the 1-group norms of the 48- and 80-filter
  convs, the padded average pools, the VALID stride-2 convs and pools).
  The deep image models' gradients (VGG16, DenseNet121, InceptionV3) are
  held in float64 on both sides: in float32 a pre-activation within
  rounding of 0 (VGG's ``conv2`` at -1.8e-8 in the port, +6.7e-8 in
  float64) flips a ReLU and moves ``conv0``–``conv2``'s gradients by up to
  8.7e-5, a kink of the function, not of either implementation (their
  logits and losses stay float32 at 1e-5);
* each model's tree: JAX's names, shapes and dtypes from the port's init,
  and an exact round trip through ``params_from_jax``/``params_to_numpy``;
  ``convert_stem_params`` equal to JAX's;
* the catalog: ``sparse_vars`` resolve as in the JAX package; lm1b's
  793472 x 512 tables are one oversized bucket each, the plan equal to
  the JAX planner's; NCF's full-width plan under ``PSLoadBalancing``
  equals the JAX planner's and the digest ``chip_smoke.py`` asserts on
  the card;
* the Strategy JSON of ``AllReduce``, ``PartitionedPS``, ``Parallax`` and
  ``PartitionedAR`` on each tiny model equals the JAX builder's;
* ``optim.adagrad`` against the JAX package's optimizer library, and its
  state through ``convert.opt_state_from_jax``;
* the BASELINE configurations on 2 gloo ranks are in
  ``tests/test_torch_models_dp.py``.
"""
import functools
import importlib
import json
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

import autodist_tpu.strategy as jstrategy
from autodist_tpu import models as jmodels
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.graph_item import VarInfo as JVarInfo
from autodist_tpu.kernel.synchronization.bucketing import \
    assign_buckets as jax_assign_buckets
from autodist_tpu.models.resnet import ResNet as JResNet
from autodist_tpu.models.resnet import _image_spec as jax_image_spec
from autodist_tpu.models.resnet import \
    convert_stem_params as jax_convert_stem
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import models, optim, strategy
from autodist_tpu_torch.convert import (opt_state_from_jax, params_from_jax,
                                        params_to_numpy)
from autodist_tpu_torch.graph_item import GraphItem, flatten
from autodist_tpu_torch.kernel.synchronization.explicit_sync import \
    plan_step_buckets
from autodist_tpu_torch.models.resnet import convert_stem_params
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import StrategyCompiler

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
import torch_dp_worker as worker  # noqa: E402

# the module (the package's ``lm1b`` attribute is the factory)
port_lm1b = importlib.import_module("autodist_tpu_torch.models.lm1b")
pytestmark = pytest.mark.torch_port

ONE_NODE = {"nodes": [{"address": "localhost", "chips": 1, "chief": True}]}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")


@functools.lru_cache(maxsize=None)
def _jax_spec(name, **over):
    """The JAX twin of :func:`torch_dp_worker.model_spec` (one per
    arguments, so :func:`_jax_params` initializes it once)."""
    cfg = dict(worker.MODEL_CFGS[name], **over)
    if name == "resnet":
        model = JResNet(cfg.pop("stage_sizes"), cfg["num_classes"],
                        stem=cfg.pop("stem", "conv7"))
        return jax_image_spec("resnet", model, **cfg)
    return {"vgg": jmodels.vgg16, "bert": jmodels.bert,
            "lm1b": jmodels.lm1b, "ncf": jmodels.ncf,
            "densenet": jmodels.densenet121,
            "inception": jmodels.inception_v3}[name](**cfg)


def _compiled(fn, *args, level=None):
    """``jax.jit(fn)(*args)``; ``level=0`` compiles at XLA's backend
    optimization level 0, in about half the time for the deep image
    models' float64 gradients (it changes float32 roundings, so float32
    values keep the default)."""
    options = {} if level is None else {
        "xla_backend_optimization_level": level}
    return jax.jit(fn).lower(*args).compile(compiler_options=options)(*args)


_PARAMS = {}


def _jax_params(jspec):
    """The JAX init's weights from key 0 as numpy, computed once per spec."""
    if id(jspec) not in _PARAMS:
        _PARAMS[id(jspec)] = jax.tree.map(
            np.asarray, _compiled(jspec.init, jax.random.PRNGKey(0)))
    return _PARAMS[id(jspec)]


# --- parity on converted weights ------------------------------------------


def _port_value_and_grads(spec, params, batch, dtype=torch.float32):
    tree = params_from_jax(params)
    leaves = {n: x.to(dtype).requires_grad_(True) for n, x in flatten(tree)}
    tree = worker.unflatten(list(leaves.items()))
    loss = spec.loss_fn(tree, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (float(loss.detach()),
            {n: g.double().numpy() for n, g in zip(leaves, grads)})


def _assert_grads_close(got, want, tol):
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n], np.asarray(want[n]), err_msg=n,
                                   **tol)


def _check_parity(jspec, spec, params, batch, inputs, grads_f64=False,
                  level=None):
    """Logits (``apply_fn(params, *inputs)``), loss and gradients
    (``level``: :func:`_compiled`'s, for the float64 gradients)."""
    jlogits, jloss = _compiled(lambda p, b: (jspec.apply_fn(p, *inputs),
                                             jspec.loss_fn(p, b)),
                               params, batch)
    tree = params_from_jax(params)
    np.testing.assert_allclose(spec.apply_fn(tree, *inputs).detach().numpy(),
                               np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(spec.loss_fn(tree, batch)),
                               float(jloss), **TOL)
    if grads_f64:
        with jax.enable_x64(True):
            params = jax.tree.map(lambda x: x.astype(np.float64), params)
            batch = {k: v.astype(np.float64) if v.dtype == np.float32
                     else v for k, v in batch.items()}
            jloss, jgrads = _compiled(jax.value_and_grad(jspec.loss_fn),
                                      params, batch, level=level)
            jgrads = dict(flatten(jax.tree.map(np.asarray, jgrads)))
        loss, grads = _port_value_and_grads(spec, params, batch,
                                            torch.float64)
    else:
        jloss, jgrads = _compiled(jax.value_and_grad(jspec.loss_fn), params,
                                  batch)
        jgrads = dict(flatten(jax.tree.map(np.asarray, jgrads)))
        loss, grads = _port_value_and_grads(spec, params, batch)
    np.testing.assert_allclose(loss, float(jloss), **TOL)
    _assert_grads_close(grads, jgrads, TOL)


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
def test_resnet_matches_jax(stem):
    jspec, spec = _jax_spec("resnet", stem=stem), worker.model_spec("resnet",
                                                              stem=stem)
    params = _jax_params(jspec)
    batch = jspec.sample_batch(4, seed=2)
    _check_parity(jspec, spec, params, batch, (batch["images"],))


def test_resnet_stem_conversion_matches_jax():
    """``convert_stem_params`` gives JAX's kernel bit for bit, and the
    converted s2d model computes the conv7 model's function (the JAX
    test's rtol 2e-4 / atol 2e-5)."""
    params = _jax_params(_jax_spec("resnet"))
    want = np.asarray(jax_convert_stem(params)["conv_init"]["kernel"])
    np.testing.assert_array_equal(
        convert_stem_params(params)["conv_init"]["kernel"], want)
    tree = params_from_jax(params)
    got = convert_stem_params(tree)["conv_init"]["kernel"]
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    y7 = worker.model_spec("resnet").apply_fn(tree, x)
    y4 = worker.model_spec("resnet", stem="s2d").apply_fn(
        convert_stem_params(tree), x)
    np.testing.assert_allclose(y4.detach().numpy(), y7.detach().numpy(),
                               rtol=2e-4, atol=2e-5)


def test_vgg16_matches_jax_at_64():
    jspec, spec = (_jax_spec("vgg", image_size=64),
                   worker.model_spec("vgg", image_size=64))
    params = _jax_params(jspec)
    assert params["fc1"]["kernel"].shape == (2 * 2 * 512, 4096)
    batch = jspec.sample_batch(2, seed=2)
    _check_parity(jspec, spec, params, batch, (batch["images"],),
                  grads_f64=True)


def test_bert_matches_jax():
    jspec, spec = _jax_spec("bert"), worker.model_spec("bert")
    params = _jax_params(jspec)
    batch = jspec.sample_batch(4, seed=2)
    _check_parity(jspec, spec, params, batch,
                  (batch["tokens"], batch["segment_ids"]))


def test_lm1b_chunked_matches_jax():
    jspec, spec = _jax_spec("lm1b"), worker.model_spec("lm1b")
    params = _jax_params(jspec)
    batch = jspec.sample_batch(4, seed=2)
    _check_parity(jspec, spec, params, batch, (batch["tokens"],))


def _jax_negatives(tokens, k, v):
    """The JAX factory's draw for a batch (``lm1b.py:74-75``)."""
    import jax.numpy as jnp

    key = jax.random.fold_in(jax.random.PRNGKey(0),
                             jnp.sum(jnp.asarray(tokens)) & 0x7FFFFFFF)
    return np.array(jax.random.randint(key, (k,), 0, v))


def test_lm1b_sampled_matches_jax_with_its_negatives(monkeypatch):
    """``sampled_softmax=16``: the port's loss on the JAX draw's negatives
    (``batch_negatives`` patched to return them) equals the JAX loss,
    gradients too."""
    monkeypatch.setattr(
        port_lm1b, "batch_negatives", lambda tokens, k, v: torch.from_numpy(
            _jax_negatives(tokens.numpy().astype(np.int32), k, v)))
    jspec = _jax_spec("lm1b", sampled_softmax=16)
    spec = worker.model_spec("lm1b", sampled_softmax=16)
    params = _jax_params(jspec)
    batch = jspec.sample_batch(4, seed=2)
    _check_parity(jspec, spec, params, batch, (batch["tokens"],))


def test_ncf_matches_jax():
    jspec, spec = _jax_spec("ncf"), worker.model_spec("ncf")
    params = _jax_params(jspec)
    batch = jspec.sample_batch(16, seed=2)
    _check_parity(jspec, spec, params, batch,
                  (batch["users"], batch["items"]))


def test_densenet121_matches_jax_at_32():
    jspec, spec = _jax_spec("densenet"), worker.model_spec("densenet")
    params = _jax_params(jspec)
    batch = jspec.sample_batch(2, seed=2)
    _check_parity(jspec, spec, params, batch, (batch["images"],),
                  grads_f64=True, level=0)


def test_inception_v3_matches_jax_at_75():
    jspec, spec = _jax_spec("inception"), worker.model_spec("inception")
    params = _jax_params(jspec)
    assert params["mixed10"]["b3_3b"]["conv"]["kernel"].shape == \
        (3, 1, 384, 384)
    batch = jspec.sample_batch(2, seed=2)
    _check_parity(jspec, spec, params, batch, (batch["images"],),
                  grads_f64=True, level=0)


# --- trees, conversion, catalog, strategies -------------------------------

NAMES = ("resnet", "vgg", "bert", "lm1b", "ncf", "densenet", "inception")


@pytest.mark.parametrize("name", NAMES)
def test_tree_matches_jax_and_round_trips(name):
    params = _jax_params(_jax_spec(name))
    mine = worker.model_spec(name).init(0, device="cpu")
    want = {n: (x.shape, str(x.dtype)) for n, x in flatten(params)}
    assert {n: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for n, x in flatten(mine)} == want
    back = dict(flatten(params_to_numpy(params_from_jax(params))))
    assert back.keys() == want.keys()
    for n, x in flatten(params):
        assert back[n].dtype == x.dtype
        np.testing.assert_array_equal(back[n], x)


@pytest.mark.parametrize("name", NAMES)
def test_catalog_matches_jax(name):
    """Variable names, shapes, dtypes and the sparse flags (exact name or
    path prefix, never a substring: ``embedding`` and
    ``softmax_embedding`` are both listed for lm1b)."""
    jspec, spec = _jax_spec(name), worker.model_spec(name)
    params = _jax_params(jspec)
    assert spec.sparse_vars == jspec.sparse_vars
    want = [v.to_dict() for v in JGraphItem(
        params, sparse_vars=jspec.sparse_vars).info.variables]
    got = [v.to_dict() for v in GraphItem(
        params_from_jax(params), sparse_vars=spec.sparse_vars).info.variables]
    assert got == want
    assert {v["name"] for v in got if v["sparse"]} == \
        {n for n in spec.sparse_vars}


def test_lm1b_full_width_tables_are_one_bucket_each():
    """At lm1b's defaults each 793472 x 512 table (406.3 M elements) is one
    oversized bucket of its own under ``Parallax``, and the plan equals the
    JAX planner's on the same entries (shapes only: meta tensors)."""
    shapes = jax.eval_shape(jmodels.lm1b().init, jax.random.PRNGKey(0))
    spec = models.lm1b()
    meta = worker.unflatten([(n, torch.empty(s.shape, device="meta"))
                             for n, s in flatten(shapes)])
    gi = GraphItem(meta, sparse_vars=spec.sparse_vars)
    table = [v for v in gi.info.variables if v.name == "embedding"][0]
    assert table.byte_size == 793472 * 512 * 4 == JVarInfo(
        "embedding", table.shape, table.dtype).byte_size
    built = strategy.Parallax().build(gi, ResourceSpec(
        resource_info=ONE_NODE))
    compiled = StrategyCompiler(None).compile(built, gi)
    for d in (1, 8):
        buckets = plan_step_buckets(gi, compiled, d)
        rs = [b for b in buckets if b.mode == "reduce_scatter"]
        assert sorted(b.names for b in rs) == [("embedding",),
                                               ("softmax_embedding",)]
        assert all(b.total == 793472 * 512 for b in rs)
        assert all(b.mode == "all_reduce" for b in buckets if b not in rs)
        want = jax_assign_buckets(
            [(v.name, v.shape, v.dtype, "NoneCompressor", 0,
              compiled.var_plans[v.name].sync_mode)
             for v in gi.info.variables], shard_divisor=d)
        assert [(b.key, b.names, b.total, b.padded_total) for b in buckets] \
            == [(b.key, tuple(v.name for v in b.vars), b.total,
                 b.padded_total) for b in want]


def test_ncf_full_width_plan_matches_jax_and_the_chip_check():
    """At NCF's defaults under ``PSLoadBalancing`` (every variable on PS)
    the plan equals the JAX planner's on the same entries (shapes only:
    meta tensors) at data sizes 1 and 8, the four tables (31,727,616
    elements) in reduce-scatter buckets; at size 1 its digest is the one
    ``chip_smoke.py``'s ``train_ncf`` asserts on the card."""
    shapes = jax.eval_shape(jmodels.ncf().init, jax.random.PRNGKey(0))
    spec = models.ncf()
    meta = worker.unflatten([(n, torch.empty(s.shape, device="meta"))
                             for n, s in flatten(shapes)])
    gi = GraphItem(meta, sparse_vars=spec.sparse_vars)
    assert sum(v.byte_size for v in gi.info.variables
               if v.name in spec.sparse_vars) == 31_727_616 * 4
    built = strategy.PSLoadBalancing().build(gi, ResourceSpec(
        resource_info=ONE_NODE))
    compiled = StrategyCompiler(None).compile(built, gi)
    for d in (1, 8):
        buckets = plan_step_buckets(gi, compiled, d)
        assert all(b.mode == "reduce_scatter" for b in buckets)
        assert sorted(n for b in buckets for n in b.names) == \
            sorted(v.name for v in gi.info.variables)
        want = jax_assign_buckets(
            [(v.name, v.shape, v.dtype, "NoneCompressor", 0,
              compiled.var_plans[v.name].sync_mode)
             for v in gi.info.variables], shard_divisor=d)
        assert [(b.key, b.names, b.total, b.padded_total) for b in buckets] \
            == [(b.key, tuple(v.name for v in b.vars), b.total,
                 b.padded_total) for b in want]
        if d == 1:
            assert len(buckets) == chip_smoke.NCF_BUCKETS
            assert chip_smoke._plan_digest(buckets) == \
                chip_smoke.NCF_PLAN_SHA256


def _jax_to_port_json(strategy_dict):
    return json.loads(json.dumps(strategy_dict).replace(":TPU:", ":GPU:"))


@pytest.mark.parametrize("builder", ["AllReduce", "PartitionedPS",
                                     "Parallax", "PartitionedAR"])
@pytest.mark.parametrize("name", NAMES)
def test_strategy_json_matches_jax(name, builder):
    jspec = _jax_spec(name)
    params = _jax_params(jspec)
    kw = {"sparse_vars": jspec.sparse_vars}
    want = getattr(jstrategy, builder)().build(
        JGraphItem(params, **kw), JResourceSpec(resource_info=ONE_NODE))
    got = getattr(strategy, builder)().build(
        GraphItem(params_from_jax(params), **kw),
        ResourceSpec(resource_info=ONE_NODE))
    want.id = got.id = "pinned"
    assert got.to_dict() == _jax_to_port_json(want.to_dict())


def test_all_models_are_the_ported_entries_of_jax():
    assert set(models.ALL_MODELS) == set(jmodels.ALL_MODELS)


# --- adagrad ---------------------------------------------------------------


@pytest.mark.parametrize("init", [0.1, 0.0])
def test_adagrad_matches_jax(init):
    """3 steps on a tree with a zero-gradient leaf (where the sum of squares
    stays at ``init``: 0 takes the ``where`` branch): parameters and state
    at rtol 1e-6 / atol 1e-7; ``opt_state_from_jax`` carries the state."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": {"c": rng.randn(4).astype(np.float32)}}
    grads = [{"a": rng.randn(5, 3).astype(np.float32),
              "b": {"c": np.zeros(4, np.float32)}} for _ in range(3)]
    jopt = optax.adagrad(0.1, initial_accumulator_value=init)
    jp, jstate = params, jopt.init(params)
    opt = optim.adagrad(0.1, initial_accumulator_value=init)
    tp = params_from_jax(params)
    state = opt.init(tp)
    for g in grads:
        upd, jstate = jopt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step_(tp, dict(flatten(params_from_jax(g))), state)
    for n, x in flatten(jax.tree.map(np.asarray, jp)):
        np.testing.assert_allclose(dict(flatten(tp))[n].numpy(), x,
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    carried = opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    assert set(carried) == {"sum_of_squares"}
    for (n, got), (_, x) in zip(flatten(state["sum_of_squares"]),
                                flatten(carried["sum_of_squares"])):
        np.testing.assert_allclose(got.numpy(), x.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    assert all(torch.isfinite(x).all() for _, x in flatten(tp))
