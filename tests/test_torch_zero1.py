"""The port's ``Zero1`` strategy and its explicit bucketed step against the
JAX package.

The JAX side runs on its 8-device CPU mesh (where it takes its explicit
step), the port on one CPU rank or on two gloo ranks
(``tests/torch_dp_worker.py``).  Both start from the same weights and
train on the same batch with ``fusable_adam`` and ``numerics={"clip_norm":
...}``: the guard's statistics through K4's plain version and the shard
update through K5's.  Tolerances: losses and global norms at rtol 1e-5
(float32, another summation order); parameters at atol 1e-4 on the
transformer (Adam's normalized step turns f32-level differences in
near-zero gradients into parameter differences near 1e-5, as in
``tests/test_torch_training.py``) and 1e-5 between port runs.
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
from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.ops.fused_kernels import fusable_adam as jax_fusable_adam
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import Zero1 as JZero1
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.convert import (opt_state_from_jax, params_from_jax,
                                        params_to_numpy, sync_state_from_jax)
from autodist_tpu_torch.graph_item import GraphItem, flatten
from autodist_tpu_torch.kernel.synchronization.explicit_sync import \
    plan_step_buckets
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.numerics import NUMERICS_KEY
from autodist_tpu_torch.ops.fused_kernels import fusable_adam
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import StrategyCompiler, Zero1

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_worker  # noqa: E402
import torch_launch  # noqa: E402

pytestmark = pytest.mark.torch_port

CFG = torch_dp_worker.CFG
ONE_NODE = {"nodes": [{"address": "localhost", "chips": 1, "chief": True}]}
WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
NUMERICS = {"clip_norm": torch_dp_worker.CLIP}


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")


@pytest.fixture(scope="module")
def params0():
    """The worker's initial weights (the port's init from seed 0) as
    numpy, the tree both packages start from."""
    return params_to_numpy(transformer_lm(**CFG).init(0, device="cpu"))


def _jax_session(params, builder=None, opt=None, **capture):
    jax_reset()
    ad = JAutoDist(strategy_builder=builder or JZero1())
    jspec = jax_lm(**CFG, attn_fn=jax_dense)
    with ad.scope():
        ad.capture(params=params, optimizer=opt or jax_fusable_adam(1e-2),
                   loss_fn=jspec.loss_fn, sparse_vars=jspec.sparse_vars,
                   **capture)
    return ad.create_distributed_session()


def _port_session(params, builder=None, opt=None, **capture):
    _reset_default_autodist_for_testing()
    spec = transformer_lm(**CFG)
    ad = AutoDist(strategy_builder=builder or Zero1(), device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params),
                   optimizer=opt or fusable_adam(1e-2),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   **capture)
    return ad.create_distributed_session()


def _batch():
    return transformer_lm(**CFG).sample_batch(8, seed=1)


def _assert_params_close(got, want, atol=1e-4):
    got, want = dict(flatten(got)), dict(flatten(want))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=0, atol=atol, err_msg=name)


def _plan(buckets):
    return [(b.key, b.names, [(v.offset, v.shape) for v in b.vars], b.total,
             b.padded_total) for b in buckets]


def _port_plan(params, d, builder=None):
    gi = GraphItem(params_from_jax(params), sparse_vars=("embed",))
    strategy = (builder or Zero1()).build(
        gi, ResourceSpec(resource_info=ONE_NODE))
    return plan_step_buckets(gi, StrategyCompiler(None).compile(strategy, gi),
                             d)


def test_zero1_strategy_json_matches_jax(params0):
    kw = dict(sparse_vars=("embed",), untrainable_vars=("pos_embed",))
    jgi, gi = JGraphItem(params0, **kw), GraphItem(params_from_jax(params0),
                                                   **kw)
    for args in ({}, {"bucket_bytes": 1 << 10, "chunk_size": 3,
                      "overlap": "none"}):
        want = JZero1(**args).build(jgi, JResourceSpec(resource_info=ONE_NODE))
        got = Zero1(**args).build(gi, ResourceSpec(resource_info=ONE_NODE))
        want.id = got.id = "pinned"
        want = want.to_dict()
        want["graph_config"]["replicas"] = ["localhost:GPU:0"]
        assert got.to_dict() == want


@pytest.mark.parametrize("kwargs", [{"bucket_bytes": 0}, {"chunk_size": 0},
                                    {"overlap": "sometimes"}])
def test_zero1_builder_refuses_what_jax_refuses(kwargs):
    with pytest.raises(ValueError):
        JZero1(**kwargs)
    with pytest.raises(ValueError):
        Zero1(**kwargs)


def test_zero1_bucket_plan_matches_jax(params0):
    """The port's plan at data size 8 equals the JAX session's ZeRO-1 plan
    on its 8-device mesh, padding included."""
    jsess = _jax_session(params0, numerics=NUMERICS)
    assert _plan(_port_plan(params0, 8)) == _plan(jsess.zero1_buckets)
    assert all(b.padded_total % 8 == 0 for b in jsess.zero1_buckets)


def test_full_width_plan_has_the_slice_buckets():
    """``transformer_lm()`` at full width packs into 75 buckets at the
    default 4 MB cap, the same plan as the JAX package's."""
    shapes = jax.eval_shape(jax_lm().init, jax.random.PRNGKey(0))
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        shapes)
    gi = GraphItem(meta)
    strategy = Zero1().build(gi, ResourceSpec(resource_info=ONE_NODE))
    plan = plan_step_buckets(gi, StrategyCompiler(None).compile(strategy, gi),
                             1)
    sizes = sorted(b.total for b in plan)
    assert len(plan) == 75
    assert {s: sizes.count(s) for s in set(sizes)} == {
        589_824: 36, 2_359_296: 24, 591_360: 12, 24_674_304: 1,
        786_432: 1, 768: 1}
    jgi = JGraphItem(shapes)
    jentries = [(v.name, tuple(v.shape), str(v.dtype), "NoneCompressor",
                 i // 512, "reduce_scatter")
                for i, v in enumerate(jgi.trainable_var_infos)]
    from autodist_tpu.kernel.synchronization.bucketing import assign_buckets
    assert _plan(plan) == _plan(assign_buckets(jentries))


def test_zero1_trains_like_jax_and_continues_from_its_state(params0):
    """Five steps against JAX ``Zero1()``; then the JAX session's state
    after 2 steps (params, ZeRO-1 optimizer state, numerics state),
    converted, continues in a fresh port session exactly as JAX does."""
    batch = _batch()
    jsess = _jax_session(params0, numerics=NUMERICS)
    sess = _port_session(params0, numerics=NUMERICS)
    assert sess._step.fused_kernels == ("guard", "update")
    jlosses = []
    for step in range(5):
        want, got = jsess.run(batch), sess.run(batch)
        jlosses.append(float(want["loss"]))
        np.testing.assert_allclose(float(got["loss"]), jlosses[-1],
                                   rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(float(got["grad_health"].global_norm),
                                   float(want["grad_health"].global_norm),
                                   rtol=1e-5)
        assert list(got["grad_health"].per_bucket) == \
            list(want["grad_health"].per_bucket)
        if step == 1:
            jstate = jax.tree.map(np.asarray, jsess.export_state())
            jsync = jax.tree.map(np.asarray, jsess.sync_state)
    _assert_params_close(sess.params, jax.tree.map(np.asarray, jsess.params))

    resumed = _port_session(params0, numerics=NUMERICS)
    resumed.import_state(
        params_from_jax(jstate[0]),
        opt_state_from_jax(jstate[1], zero1_buckets=resumed.zero1_buckets),
        step=2, sync_state=sync_state_from_jax(jsync))
    assert int(resumed.sync_state[NUMERICS_KEY]["step"]) == 2
    assert int(resumed.opt_state["zero1"]["count"]) == 2
    losses = [float(resumed.run(batch)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses[2:], rtol=1e-5)
    assert int(resumed.sync_state[NUMERICS_KEY]["step"]) == 5
    _assert_params_close(resumed.params,
                         jax.tree.map(np.asarray, jsess.params))
    # the logical state: full bucket vectors equal to JAX's
    _, logical = sess.export_state()
    _, jlogical = jax.tree.map(np.asarray, jsess.export_state())
    for key, vec in logical["zero1"]["mu"].items():
        want = jlogical["zero1"][0].mu[key]
        np.testing.assert_allclose(vec.numpy(), want[:vec.numel()],
                                   rtol=0, atol=1e-6, err_msg=key)
    assert logical["vars"]["mu"] == {}


def test_zero1_accumulation_matches_jax_overlap_none(params0):
    """``accum_steps=2``: the port's phase-serial step against JAX
    ``Zero1(overlap="none")``, 16 rows (2 per JAX device)."""
    batch = transformer_lm(**CFG).sample_batch(16, seed=2)
    jsess = _jax_session(params0, JZero1(overlap="none"), accum_steps=2,
                         numerics=NUMERICS)
    sess = _port_session(params0, accum_steps=2, numerics=NUMERICS)
    want = [float(jsess.run(batch)["loss"]) for _ in range(3)]
    got = [float(sess.run(batch)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(sess.params, jax.tree.map(np.asarray, jsess.params))


def test_zero1_without_fusable_adam_warns_and_matches_jax(params0):
    """``adamw`` cannot run K5: the shards take the optimizer's own update,
    with the drop reason in a warning; no guard without ``numerics``."""
    batch = _batch()
    jsess = _jax_session(params0, opt=optax.adamw(1e-2, weight_decay=1e-4))
    with pytest.warns(UserWarning, match="fusable_adam"):
        sess = _port_session(params0, opt=optim.adamw(1e-2))
    assert sess._step.fused_kernels == ()
    want = [float(jsess.run(batch)["loss"]) for _ in range(3)]
    outs = [sess.run(batch) for _ in range(3)]
    assert all("grad_health" not in o for o in outs)
    np.testing.assert_allclose([float(o["loss"]) for o in outs], want,
                               rtol=1e-5)
    _assert_params_close(sess.params, jax.tree.map(np.asarray, jsess.params))


@pytest.mark.parametrize("builder,item", [
    (Zero1(compressor="HorovodCompressor"), "P6"),
    (Zero1(overlap="pipeline"), "P6"), (Zero1(hier=True), "P6"),
    (Zero1(compressor="HorovodCompressorEF"), "P6")])
def test_zero1_options_still_to_port_raise(params0, builder, item):
    """Once refused naming P6, these options train now: on one rank they
    equal the plain ``Zero1()`` session (``fusable_adam``, the guard with
    its clip) bit for bit, losses, global norms and parameters, and the
    JAX session's losses at rtol 1e-5."""
    import warnings

    batch = _batch()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # pipeline at accum_steps=1
        sess = _port_session(params0, builder,
                             numerics=NUMERICS)
    plain = _port_session(params0, numerics=NUMERICS)
    jsess = _jax_session(params0, numerics=NUMERICS)
    for _ in range(3):
        got, want = sess.run(batch), plain.run(batch)
        assert float(got["loss"]) == float(want["loss"])
        assert float(got["grad_health"].global_norm) == \
            float(want["grad_health"].global_norm)
        np.testing.assert_allclose(float(got["loss"]),
                                   float(jsess.run(batch)["loss"]), rtol=1e-5)
    for (n, a), (_, b) in zip(flatten(sess.params), flatten(plain.params)):
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_two_gloo_ranks_shard_the_state_and_match_jax(params0, tmp_path):
    """Zero1 on 2 gloo ranks: losses equal the 1-rank port's and the JAX
    8-device mesh's; each rank holds ``padded_total / 2`` of every bucket's
    moments; ``export_state`` gives every rank the full logical state; and
    the JAX state after 3 steps, sliced per rank, continues as JAX does."""
    batch = _batch()
    cap = torch_dp_worker.ZERO1_BUCKET_BYTES
    jsess = _jax_session(params0, JZero1(cap), numerics=NUMERICS)
    jres = [jsess.run(batch) for _ in range(3)]
    jparams, jopt = jax.tree.map(np.asarray, jsess.export_state())
    jsync = jax.tree.map(np.asarray, jsess.sync_state)
    jresumed = [float(jsess.run(batch)["loss"]) for _ in range(2)]
    plan = _port_plan(params0, 2, Zero1(cap))
    assert len(plan) > 2
    torch.save({r: {"params": params_from_jax(jparams),
                    "opt_state": opt_state_from_jax(
                        jopt, zero1_buckets=plan, rank=r, data=2),
                    "sync_state": sync_state_from_jax(jsync), "step": 3}
                for r in range(2)}, tmp_path / "state.pt")

    torch_launch.run(
        lambda rank, init: [WORKER, rank, 2, init,
                            tmp_path / f"rank{rank}.npz", "zero1",
                            tmp_path / "state.pt"],
        world=2, tmp_dir=tmp_path, timeout=120)

    _reset_default_autodist_for_testing()
    losses, params, sess = torch_dp_worker.train("zero1")
    _, logical = sess.export_state()
    outs = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for r, out in enumerate(outs):
        assert int(out["data_axis"]) == 2
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(out["losses"],
                                   [float(x["loss"]) for x in jres],
                                   rtol=1e-5)
        np.testing.assert_allclose(
            out["norms"], [float(x["grad_health"].global_norm)
                           for x in jres], rtol=1e-5)
        for name, value in params.items():
            np.testing.assert_allclose(out[f"p:{name}"], value, rtol=0,
                                       atol=1e-5, err_msg=name)
        for b in plan:
            assert int(out[f"shard:{b.key}"]) == b.padded_total // 2
            for m in ("mu", "nu"):
                full = out[f"full_{m}:{b.key}"]
                assert full.shape == (b.padded_total,)
                np.testing.assert_array_equal(full, outs[0][f"full_{m}:"
                                                            f"{b.key}"])
                np.testing.assert_allclose(
                    full[:b.total], logical["zero1"][m][b.key][:b.total]
                    .numpy(), rtol=0, atol=1e-6, err_msg=f"{m} {b.key}")
        np.testing.assert_allclose(out["resumed"], jresumed, rtol=1e-5)
        _assert_params_close({k[3:]: out[k] for k in out.files
                              if k.startswith("rp:")},
                             jax.tree.map(np.asarray, jsess.params))
