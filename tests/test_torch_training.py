"""The port's training slice against the JAX package: the AutoDist facade
with the ``AllReduce`` strategy, its Strategy JSON, the bucket planner,
gradient accumulation, data parallelism over gloo CPU ranks, optimizer
state carried across, and the options that still raise.

Both sides start from the same weights (the JAX init, carried by
``convert.params_from_jax``) and train on the same numpy batch.  The JAX
side runs on one CPU device.  Tolerances: losses at rtol 1e-5 (float32,
different summation order); final parameters at atol 1e-4, because Adam's
normalized step turns float32-level differences in near-zero gradients
into parameter differences up to ~1e-5 after a few steps at lr 1e-2.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.kernel.synchronization.bucketing import \
    assign_buckets as jax_assign_buckets
from autodist_tpu.mesh import build_mesh as jax_build_mesh
from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.ops.flash_attention import \
    make_flash_attention as jax_make_flash
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.convert import (opt_state_from_jax,
                                        opt_state_to_numpy, params_from_jax,
                                        params_to_numpy)
from autodist_tpu_torch.graph_item import GraphItem, flatten, unflatten
from autodist_tpu_torch.kernel.synchronization.bucketing import (
    assign_buckets, pack_bucket, unpack_bucket)
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops.flash_attention import flash_attention
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import (AllReduce, PSSynchronizerConfig,
                                         Strategy, StrategyBuilder,
                                         VarConfig)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_worker  # noqa: E402
import torch_launch  # noqa: E402

pytestmark = pytest.mark.torch_port

CFG = dict(vocab_size=97, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
           max_len=16)
ONE_NODE = {"nodes": [{"address": "localhost", "chips": 1, "chief": True}]}
WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    jax_reset()
    _reset_default_autodist_for_testing()


@pytest.fixture(scope="module")
def jmodel():
    jspec = jax_lm(**CFG, attn_fn=jax_dense)
    params = jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    return jspec, params


def _jax_session(jspec, params, opt, builder=None, **capture):
    jax_reset()
    ad = JAutoDist(strategy_builder=builder or JAllReduce())
    with ad.scope():
        ad.capture(params=params, optimizer=opt, loss_fn=jspec.loss_fn,
                   sparse_vars=jspec.sparse_vars, **capture)
    return ad.create_distributed_session(
        mesh=jax_build_mesh(devices=jax.devices()[:1]))


def _port_session(spec, params, opt, builder=None, **capture):
    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=builder or AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params), optimizer=opt,
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   **capture)
    return ad.create_distributed_session()


def _assert_params_close(got, want, atol=1e-4):
    got, want = dict(flatten(got)), dict(flatten(want))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("attention,accum", [("dense", 1), ("flash", 1),
                                             ("dense", 2), ("dense", 3)])
def test_facade_trajectory_matches_jax(jmodel, attention, accum):
    """JAX ``AutoDist(AllReduce())`` vs the port's, 5 ``adam(1e-2)`` steps
    on batch 8: default (dense on the CPU) attention; the flash kernels on
    both sides (JAX Pallas interpret mode vs the port's plain path); even
    (2) and uneven (3) gradient accumulation."""
    _, params = jmodel
    batch = jax_lm(**CFG).sample_batch(8, seed=1)
    if attention == "flash":
        jspec = jax_lm(**CFG, attn_fn=jax_make_flash(
            block_q=8, block_k=8, interpret=True))
        spec = transformer_lm(**CFG, attn_fn=flash_attention)
    else:
        jspec, spec = jax_lm(**CFG, attn_fn=jax_dense), transformer_lm(**CFG)
    jsess = _jax_session(jspec, params, optax.adam(1e-2), accum_steps=accum)
    sess = _port_session(spec, params, optim.adam(1e-2), accum_steps=accum)
    want = [float(jsess.run(batch)["loss"]) for _ in range(5)]
    got = [float(sess.run(batch)["loss"]) for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(sess.params, jax.tree.map(np.asarray, jsess.params))
    assert sess.step_count == 5
    np.testing.assert_allclose(float(sess.evaluate(batch)["loss"]),
                               float(jsess.evaluate(batch)["loss"]),
                               rtol=1e-5)


def test_evaluate_and_metrics_match_jax(jmodel):
    jspec, params = jmodel
    spec = transformer_lm(**CFG)
    batches = [jspec.sample_batch(4, seed=s) for s in (2, 3)]

    def jmetrics(p, b):
        return {"tokens": np.float32(b["tokens"].size)}

    def metrics(p, b):
        return {"tokens": torch.tensor(float(b["tokens"].numel()))}

    jsess = _jax_session(jspec, params, optax.sgd(0.1), metrics_fn=jmetrics)
    sess = _port_session(spec, params, optim.sgd(0.1), metrics_fn=metrics)
    want, got = jsess.evaluate(batches), sess.evaluate(batches)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    assert float(got["tokens"]) == float(want["tokens"]) == 64.0
    out = sess.run(batches[0])
    assert set(out) == {"loss", "tokens"}
    assert sess.evaluate([]) is None


def test_session_continues_from_jax_state(jmodel):
    """Two JAX steps, then params and adam state carried into the port's
    session by ``convert``; one more step on each side."""
    jspec, params = jmodel
    batch = jspec.sample_batch(8, seed=4)
    jsess = _jax_session(jspec, params, optax.adam(1e-2))
    for _ in range(2):
        jsess.run(batch)
    jparams, jstate = jax.tree.map(np.asarray, jsess.export_state())
    sess = _port_session(transformer_lm(**CFG), params, optim.adam(1e-2))
    sess.import_state(params_from_jax(jparams), opt_state_from_jax(jstate),
                      step=2)
    want = float(jsess.run(batch)["loss"])
    got = float(sess.run(batch)["loss"])
    assert got == pytest.approx(want, rel=1e-5)
    assert sess.step_count == 3
    _assert_params_close(sess.params, jax.tree.map(np.asarray, jsess.params))
    _, want_state = jax.tree.map(np.asarray, jsess.export_state())
    got_state = opt_state_to_numpy(sess.opt_state)
    assert int(got_state["count"]) == 3
    _assert_params_close(got_state["mu"],
                         opt_state_to_numpy(opt_state_from_jax(
                             want_state))["mu"], atol=1e-5)


def test_frozen_variables_match_jax(jmodel):
    jspec, params = jmodel
    batch = jspec.sample_batch(8, seed=5)
    jsess = _jax_session(jspec, params, optax.adam(1e-2),
                         untrainable_vars=("pos_embed",))
    sess = _port_session(transformer_lm(**CFG), params, optim.adam(1e-2),
                         untrainable_vars=("pos_embed",))
    want = [float(jsess.run(batch)["loss"]) for _ in range(3)]
    got = [float(sess.run(batch)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(sess.params["pos_embed"],
                                  params["pos_embed"])
    assert "pos_embed" not in sess.opt_state["mu"]
    assert not sess.device_params["pos_embed"].requires_grad


@pytest.mark.parametrize("chunk_size", [128, 4])
def test_allreduce_strategy_json_matches_jax(jmodel, tmp_path, chunk_size):
    _, params = jmodel
    kw = dict(sparse_vars=("embed",), untrainable_vars=("pos_embed",))
    jgi = JGraphItem(params, **kw)
    gi = GraphItem(params_from_jax(params), **kw)
    assert [v.to_dict() for v in gi.info.variables] == \
        [v.to_dict() for v in jgi.info.variables]
    jstrategy = JAllReduce(chunk_size=chunk_size).build(
        jgi, JResourceSpec(resource_info=ONE_NODE))
    strategy = AllReduce(chunk_size=chunk_size).build(
        gi, ResourceSpec(resource_info=ONE_NODE))
    jstrategy.id = strategy.id = "pinned"
    want = jstrategy.to_dict()
    # the port's chips are GPUs: the replica names say so, nothing else
    assert strategy.to_dict()["graph_config"]["replicas"] == ["localhost:GPU:0"]
    want["graph_config"]["replicas"] = ["localhost:GPU:0"]
    assert strategy.to_dict() == want
    jstrategy.serialize(str(tmp_path / "pinned"))
    loaded = Strategy.deserialize("pinned", base_dir=str(tmp_path))
    assert loaded.to_dict() == jstrategy.to_dict()


@pytest.mark.parametrize("info", [
    {"nodes": [{"address": "10.0.0.1", "chips": 4},
               {"address": "10.0.0.2", "gpus": [0, 1], "chief": True}],
     "mesh": {"data": 6}},
    {"nodes": [{"address": "solo", "cpus": [0, 1]}]},
])
def test_resource_spec_schema_matches_jax(info, tmp_path):
    import yaml

    path = tmp_path / "spec.yml"
    path.write_text(yaml.safe_dump(info))
    want = JResourceSpec(str(path))
    got = ResourceSpec(str(path))
    assert [(n.address, n.chips, n.cpus, n.chief) for n in got.nodes] == \
        [(n.address, n.chips, n.cpus, n.chief) for n in want.nodes]
    assert (got.chief, got.num_chips, got.mesh_hint) == \
        (want.chief, want.num_chips, want.mesh_hint)
    assert [d.name_string() for d in got.devices] == [
        d.name_string().replace(":TPU:", ":GPU:") for d in want.devices]


def test_resource_spec_refuses_bad_schemas():
    from autodist_tpu_torch.resource_spec import ResourceSpecError

    for info in ({"nodes": []}, {"nodes": [{"chips": 1}]},
                 {"nodes": [{"address": "a", "chief": True},
                            {"address": "b", "chief": True}]},
                 {"nodes": [{"address": "a", "chief": True},
                            {"address": "a"}]}):
        with pytest.raises(ResourceSpecError):
            ResourceSpec(resource_info=info)


def _entries(infos, chunk):
    return [(v.name, tuple(v.shape), str(v.dtype), "NoneCompressor",
             i // chunk, "all_reduce") for i, v in enumerate(infos)]


def _plan(buckets):
    return [(b.key, b.names, [(v.offset, v.shape) for v in b.vars], b.total,
             b.padded_total, b.order) for b in buckets]


@pytest.mark.parametrize("bucket_bytes,chunk,divisor", [
    (0, 128, 1), (64 << 10, 128, 1), (8 << 20, 5, 4)])
def test_bucket_plan_matches_jax_on_the_full_width_catalog(
        bucket_bytes, chunk, divisor):
    jshapes = jax.eval_shape(jax_lm().init, jax.random.PRNGKey(0))
    jgi = JGraphItem(jshapes)
    shapes = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                          jshapes)
    gi = GraphItem(shapes)
    entries = _entries(gi.trainable_var_infos, chunk)
    assert entries == _entries(jgi.trainable_var_infos, chunk)
    got = assign_buckets(entries, bucket_bytes, divisor)
    assert _plan(got) == _plan(jax_assign_buckets(entries, bucket_bytes,
                                                  divisor))
    assert len(got) > 1


def test_pack_unpack_roundtrip():
    entries = [("a", (2, 3), "float32", "NoneCompressor", 0, "all_reduce"),
               ("b", (5,), "float32", "NoneCompressor", 0, "all_reduce")]
    (bucket,) = assign_buckets(entries, shard_divisor=4)
    a, b = torch.randn(2, 3), torch.randn(5)
    vec = pack_bucket(bucket, [a, b])
    assert vec.shape == (12,) and bucket.pad == 1 and vec[-1] == 0
    ua, ub = unpack_bucket(bucket, vec)
    assert torch.equal(ua, a) and torch.equal(ub, b)


def test_two_gloo_ranks_match_one_rank(tmp_path):
    """Data parallelism over 2 gloo CPU ranks (each takes 4 of the 8 rows;
    gradients averaged by one all_reduce per bucket) equals 1 rank on the
    same global batch."""
    torch_launch.run(
        lambda rank, init: [WORKER, rank, 2, init,
                            tmp_path / f"rank{rank}.npz"],
        world=2, tmp_dir=tmp_path, timeout=120)
    losses, params, sess = torch_dp_worker.train()
    assert sess.data_axis_size == 1 and sess._step.buckets == ()
    for rank in range(2):
        out = np.load(tmp_path / f"rank{rank}.npz")
        assert int(out["data_axis"]) == 2 and int(out["buckets"]) >= 1
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        for name, value in params.items():
            np.testing.assert_allclose(out[f"p:{name}"], value, rtol=0,
                                       atol=1e-5, err_msg=name)


class _PSBuilder(StrategyBuilder):
    def build(self, graph_item, resource_spec):
        return Strategy(node_config=[
            VarConfig(v.name, PSSynchronizerConfig(staleness=2))
            for v in graph_item.trainable_var_infos])


@pytest.mark.parametrize("builder,capture,item", [
    (AllReduce(compressor="HorovodCompressor"), {}, "P6"),
    (AllReduce(fused_groups=True), {}, "P6"),
    (AllReduce(sync="reduce_scatter", compressor="PowerSGDCompressor"), {},
     "P6"),
    (AllReduce(bucket_bytes=1 << 20, overlap="full"), {"accum_steps": 2},
     "P6"),
    (AllReduce(overlap="pipeline"), {}, "P6"),
    (AllReduce(hier=True), {}, "P6"),
    (_PSBuilder(), {}, "P6 — pipelining, hier and staleness"),
    (AllReduce(), {"grad_fn": "autograd"}, "P10"),
    (AllReduce(), {"pipeline_vars": ("embed",)}, "P10"),
])
def test_unported_options_raise_naming_their_roadmap_item(
        jmodel, builder, capture, item):
    """The P6 and P10 options, ported, train on one rank and match their
    oracle: the compressors, fused groups, the pipeline, ``hier``, a
    ``grad_fn`` (here autograd's own gradients, handed back by hand) and
    ``pipeline_vars`` on a mesh without ``pipe`` equal the plain
    ``AllReduce()`` session bit for bit (the JAX package runs them on its
    GSPMD step at data size 1, where nothing is compressed), and
    ``staleness=2`` leaves the parameters unchanged for 2 steps, then
    applies step 1's gradient (the optimizer fed ``[0, 0, g1]``)."""
    import warnings

    _, params = jmodel
    spec = transformer_lm(**CFG)
    batch = spec.sample_batch(4, seed=2)

    def session(b, **cap):
        _reset_default_autodist_for_testing()
        ad = AutoDist(strategy_builder=b, device="cpu")
        with ad.scope():
            ad.capture(params=params_from_jax(params),
                       optimizer=optim.adam(1e-3), loss_fn=spec.loss_fn,
                       **cap)
        return ad, ad.create_distributed_session()

    if capture.get("grad_fn") == "autograd":
        def grad_fn(p, b):
            named = flatten(p)
            loss = spec.loss_fn(p, b)
            grads = torch.autograd.grad(loss, [x for _, x in named])
            return loss, unflatten([(n, g) for (n, _), g in zip(named,
                                                                grads)])
        capture = dict(capture, grad_fn=grad_fn)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the JAX fallbacks' warnings
        _, sess = session(builder, **capture)
    got = [float(sess.run(batch)["loss"]) for _ in range(3)]
    if isinstance(builder, _PSBuilder):
        opt, ref = optim.adam(1e-3), params_from_jax(params)
        state, leaves = opt.init(ref), dict(flatten(ref))
        for x in leaves.values():
            x.requires_grad_(True)
        loss = spec.loss_fn(ref, sess.place_batch(batch))
        g1 = dict(zip(leaves, torch.autograd.grad(loss,
                                                  list(leaves.values()))))
        zeros = {n: torch.zeros_like(g) for n, g in g1.items()}
        with torch.no_grad():
            for g in (zeros, zeros, g1):
                opt.step_(ref, g, state)
        assert got[0] == got[1] == float(loss.detach())
        _assert_params_close(sess.params, params_to_numpy(ref), atol=0)
        return
    _, plain = session(AllReduce(), **capture)
    want = [float(plain.run(batch)["loss"]) for _ in range(3)]
    assert got == want
    for (n, a), (_, b) in zip(flatten(sess.params), flatten(plain.params)):
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_transformer_lm_xent_chunk_matches_dense():
    """``xent_chunk`` trains with the chunked loss: the same value as the
    dense loss at the JAX test's rtol 1e-5 (``tests/test_models.py``)."""
    dense = transformer_lm(**CFG)
    params = dense.init(0, device="cpu")
    batch = dense.sample_batch(4)
    for chunk in (32, 1000):
        np.testing.assert_allclose(
            float(transformer_lm(**CFG, xent_chunk=chunk).loss_fn(params,
                                                                  batch)),
            float(dense.loss_fn(params, batch)), rtol=1e-5)


def test_unported_factory_options_and_fit_raise():
    spec = transformer_lm(**CFG)
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    ad.capture(params=spec.init(0, device="cpu"), optimizer=optim.sgd(0.1),
               loss_fn=spec.loss_fn)
    sess = ad.create_distributed_session()
    # validate=True runs since P8's first half, the tuner since its second
    # (it raised naming P8 until then)
    from autodist_tpu_torch.strategy import ScheduleTuner

    tuner = ScheduleTuner(ad.graph_item, ad.resource_spec, interval=1,
                          profile=False, calibration_path=None)
    sess.fit([spec.sample_batch(2)], validate=True, tuner=tuner)
    assert sess.step_count == 1 and tuner.swaps == 0


def test_autodist_defaults_to_ps_load_balancing(jmodel):
    """``AutoDist()`` with no builder builds ``PSLoadBalancing``'s Strategy,
    as the JAX facade does, and trains like the JAX session with that
    builder: 3 ``adam(1e-2)`` steps, losses at rtol 1e-5."""
    from autodist_tpu.strategy import PSLoadBalancing as JPSLoadBalancing
    from autodist_tpu_torch.strategy import PSLoadBalancing

    jspec, params = jmodel
    spec = transformer_lm(**CFG)
    batch = spec.sample_batch(8, seed=1)
    ad = AutoDist(device="cpu")
    with ad.scope():
        gi = ad.capture(params=params_from_jax(params),
                        optimizer=optim.adam(1e-2), loss_fn=spec.loss_fn,
                        sparse_vars=spec.sparse_vars)
    built = ad.build_strategy()
    want = PSLoadBalancing().build(gi, ResourceSpec())
    want.id = built.id
    assert built.to_dict() == want.to_dict()
    sess = ad.create_distributed_session()
    jsess = _jax_session(jspec, params, optax.adam(1e-2), JPSLoadBalancing())
    np.testing.assert_allclose(
        [float(sess.run(batch)["loss"]) for _ in range(3)],
        [float(jsess.run(batch)["loss"]) for _ in range(3)], rtol=1e-5)
    # one reduce-scatter bucket family over every trainable variable; the
    # sparse embedding, stored 1/N at data size > 1, fills its own
    assert {b.mode for b in sess._step.buckets} == {"reduce_scatter"}
    assert sorted(n for b in sess._step.buckets for n in b.names) == \
        sorted(sess._step.trainable)
    assert [b.names for b in sess._step.buckets if b.stored] == [("embed",)]


@pytest.mark.parametrize("name", ["PS", "PSLoadBalancing", "PartitionedPS",
                                  "UnevenPartitionedPS", "Parallax",
                                  "PartitionedAR", "RandomAxisPartitionAR"])
def test_ps_family_and_partitioned_builders_build(name):
    """Every builder of the PS family and the partitioned all-reduce
    builders is a ``StrategyBuilder`` whose plan covers every trainable
    variable (parity with the JAX builders' JSON:
    ``tests/test_torch_ps_family.py``)."""
    import autodist_tpu_torch.strategy as strategy

    builder = getattr(strategy, name)()
    assert isinstance(builder, StrategyBuilder)
    gi = GraphItem(transformer_lm(**CFG).init(0, device="cpu"))
    plan = builder.build(gi, ResourceSpec(resource_info=ONE_NODE))
    assert [n.var_name for n in plan.node_config] == \
        [v.name for v in gi.trainable_var_infos]


def test_non_data_mesh_axes_raise():
    """``model``, ``expert`` and ``pipe`` axes are lowered now: on this
    one-process world their size 2 does not divide the world
    (``tests/test_torch_model_axis.py``, ``tests/test_torch_moe.py`` and
    ``tests/test_torch_pipeline.py`` train on them)."""
    spec = transformer_lm(**CFG)
    for axes in ({"model": 2}, {"pipe": 2}, {"expert": 2}):
        _reset_default_autodist_for_testing()
        ad = AutoDist(strategy_builder=AllReduce(), mesh_axes=axes,
                      device="cpu")
        ad.capture(params=spec.init(0, device="cpu"),
                   optimizer=optim.sgd(0.1), loss_fn=spec.loss_fn)
        with pytest.raises(ValueError, match="divide the world size"):
            ad.create_distributed_session()


@pytest.mark.parametrize("axis", ["pipe", "expert", "seq", "model"])
def test_build_mesh_refuses_non_data_axes(axis):
    """Every axis builds (``tests/test_torch_sequence_parallel.py``,
    ``tests/test_torch_model_axis.py``, ``tests/test_torch_moe.py`` and
    ``tests/test_torch_pipeline.py`` train on them); on this one-process
    world a size of 2 does not divide the world."""
    from autodist_tpu_torch.mesh import build_mesh

    with pytest.raises(ValueError, match="divide the world size"):
        build_mesh({axis: 2}, device="cpu")
    assert build_mesh({axis: 1}, device="cpu").data_size == 1


def test_function_runs_steps_and_syncs_every_n():
    spec = transformer_lm(**CFG)
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"),
                   optimizer=optim.adamw(1e-3), loss_fn=spec.loss_fn)
    step = ad.function(lambda m: m["loss"], sync_every=2)
    batch = spec.sample_batch(4, seed=6)
    first, second = step(batch), step(batch)
    assert isinstance(first, torch.Tensor) and isinstance(second, np.ndarray)
    sess = ad.create_distributed_session()
    assert sess.step_count == 2
    assert sess.throughput(4)["steps_measured"] == 1
    with pytest.raises(RuntimeError, match="after the distributed session"):
        ad.capture(params={}, optimizer=optim.sgd(0.1), loss_fn=spec.loss_fn)


def test_aux_is_stacked_over_microbatches_and_returned_by_evaluate(jmodel):
    jspec, params = jmodel
    spec = transformer_lm(**CFG)

    def jloss(p, b):
        loss = jspec.loss_fn(p, b)
        return loss, {"twice": 2 * loss}

    def loss_fn(p, b):
        loss = spec.loss_fn(p, b)
        return loss, {"twice": 2 * loss}

    batch = jspec.sample_batch(6, seed=7)
    jax_reset()
    ad = JAutoDist(strategy_builder=JAllReduce())
    ad.capture(params=params, optimizer=optax.adam(1e-2), loss_fn=jloss,
               accum_steps=3, has_aux=True)
    jsess = ad.create_distributed_session(
        mesh=jax_build_mesh(devices=jax.devices()[:1]))
    _reset_default_autodist_for_testing()
    pad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    pad.capture(params=params_from_jax(params), optimizer=optim.adam(1e-2),
                loss_fn=loss_fn, accum_steps=3, has_aux=True)
    sess = pad.create_distributed_session()
    want, got = jsess.run(batch), sess.run(batch)
    assert got["aux"]["twice"].shape == (3,)
    np.testing.assert_allclose(got["aux"]["twice"],
                               np.asarray(want["aux"]["twice"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    ev = sess.evaluate(batch)
    assert float(ev["aux"]["twice"]) == pytest.approx(2 * float(ev["loss"]))
