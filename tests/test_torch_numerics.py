"""The port's numerics guard against the JAX package's.

The model, batches and paths are ``tests/test_numerics.py``'s: a two-layer
tanh MLP trained with Adam under ``AllReduce()`` (the per-variable
unfused guard), ``AllReduce(bucket_bytes=1 << 20)`` (the bucketed guard,
K4's plain version) and ``Zero1(bucket_bytes=1 << 20)`` (the same plus
ZeRO-1 shards and K5's plain version), all with ``clip_norm``.  The JAX
side runs on its 8-device CPU mesh, the port on one CPU rank; weights and
batches come from numpy with a seed.  Every loss is multiplied by the
mean of a batch column ``s``: ones, or NaN to poison one step in both
packages alike.

Tolerances: losses, parameters and global norms at 1e-5 (float32, another
summation order); the loss-scale sequences and the skip exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.numerics import loss_scale as jls
from autodist_tpu.numerics.policy import NumericsConfig as JNumericsConfig
from autodist_tpu.ops.fused_kernels import fusable_adam as jax_fusable_adam
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu.strategy import Zero1 as JZero1
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.numerics import (NUMERICS_KEY, GradHealth,
                                         HealthAccumulator, LossScale,
                                         NumericsConfig, resolve_loss_scale)
from autodist_tpu_torch.numerics import loss_scale as ls
from autodist_tpu_torch.ops import fused_kernels as fk
from autodist_tpu_torch.strategy import AllReduce, Zero1

pytestmark = pytest.mark.torch_port

TOL = 1e-5
CLIP = 0.05
PATHS = {
    "allreduce": (lambda: JAllReduce(), lambda: AllReduce(), "adam"),
    "bucketed": (lambda: JAllReduce(bucket_bytes=1 << 20),
                 lambda: AllReduce(bucket_bytes=1 << 20), "adam"),
    "zero1": (lambda: JZero1(bucket_bytes=1 << 20),
              lambda: Zero1(bucket_bytes=1 << 20), "fusable_adam"),
}


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")


def _params():
    rng = np.random.RandomState(0)
    return {"l0": {"w": (rng.randn(16, 16) * 0.1).astype(np.float32),
                   "b": np.zeros((16,), np.float32)},
            "l1": {"w": (rng.randn(16, 4) * 0.1).astype(np.float32)}}


def _batches(n=5, rows=32, poison_at=None):
    rng = np.random.RandomState(7)
    out = []
    for i in range(n):
        s = np.full((rows,), np.nan if i == poison_at else 1.0, np.float32)
        out.append({"x": rng.randn(rows, 16).astype(np.float32),
                    "y": rng.randn(rows, 4).astype(np.float32), "s": s})
    return out


def _jloss(p, b):
    h = jnp.tanh(b["x"] @ p["l0"]["w"] + p["l0"]["b"])
    return jnp.mean((h @ p["l1"]["w"] - b["y"]) ** 2) * jnp.mean(b["s"])


def _loss(p, b):
    h = torch.tanh(b["x"] @ p["l0"]["w"] + p["l0"]["b"])
    return ((h @ p["l1"]["w"] - b["y"]) ** 2).mean() * b["s"].mean()


def _jax_session(builder, numerics, opt="adam", accum=1):
    jax_reset()
    ad = JAutoDist(strategy_builder=builder)
    with ad.scope():
        ad.capture(params=jax.tree.map(jnp.asarray, _params()),
                   optimizer=jax_fusable_adam(1e-2) if opt == "fusable_adam"
                   else optax.adam(1e-2),
                   loss_fn=_jloss, accum_steps=accum, numerics=numerics)
    return ad.create_distributed_session()


def _port_session(builder, numerics, opt="adam", accum=1, params=None):
    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params or _params()),
                   optimizer=fk.fusable_adam(1e-2) if opt == "fusable_adam"
                   else optim.adam(1e-2),
                   loss_fn=_loss, accum_steps=accum, numerics=numerics)
    return ad.create_distributed_session()


def _assert_params_close(got, want):
    got, want = dict(flatten(got)), dict(flatten(want))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_guard_matrix_matches_jax(path):
    """Five clipped steps: losses, parameters, global norms and per-bucket
    keys and norms against the JAX package."""
    jbuild, build, opt = PATHS[path]
    numerics = {"clip_norm": CLIP}
    jsess = _jax_session(jbuild(), numerics, opt)
    sess = _port_session(build(), numerics, opt)
    for b in _batches():
        want, got = jsess.run(b), sess.run(b)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=TOL)
        gh, jh = got["grad_health"], want["grad_health"]
        assert isinstance(gh, GradHealth)
        np.testing.assert_allclose(float(gh.global_norm),
                                   float(jh.global_norm), rtol=TOL)
        assert bool(gh.all_finite) and int(gh.skipped_steps) == 0
        assert float(gh.loss_scale) == float(jh.loss_scale) == 1.0
        assert list(gh.per_bucket) == list(jh.per_bucket)
        for key, entry in gh.per_bucket.items():
            assert bool(entry["finite"])
            np.testing.assert_allclose(float(entry["sq_norm"]),
                                       float(jh.per_bucket[key]["sq_norm"]),
                                       rtol=TOL, err_msg=key)
    assert float(gh.global_norm) > CLIP      # the clip was active
    _assert_params_close(sess.params, jax.tree.map(np.asarray,
                                                   jsess.params))
    assert sess._step.fused_kernels == (
        ("guard", "update") if path == "zero1"
        else ("guard",) if path == "bucketed" else ())


def _snapshot(sess):
    return ([x.clone() for _, x in flatten(sess.device_params)],
            [x.clone() for _, x in flatten(sess.opt_state)])


@pytest.mark.parametrize("path", sorted(PATHS))
def test_poisoned_step_is_skipped_bit_identically(path):
    jbuild, build, opt = PATHS[path]
    numerics = {"clip_norm": CLIP}
    jsess = _jax_session(jbuild(), numerics, opt)
    sess = _port_session(build(), numerics, opt)
    for i, b in enumerate(_batches(4, poison_at=2)):
        before = _snapshot(sess)
        jbefore = jax.tree.map(np.asarray, jsess.params)
        want, got = jsess.run(b), sess.run(b)
        gh, jh = got["grad_health"], want["grad_health"]
        assert bool(gh.all_finite) == bool(jh.all_finite) == (i != 2)
        assert int(gh.skipped_steps) == int(jh.skipped_steps) \
            == (1 if i >= 2 else 0)
        if i == 2:
            for a, b_ in zip(before[0] + before[1], _snapshot(sess)[0]
                             + _snapshot(sess)[1]):
                assert torch.equal(a, b_)
            assert not bool(gh.per_bucket[next(iter(gh.per_bucket))]
                            ["finite"])
            for x, y in zip(jax.tree.leaves(jbefore),
                            jax.tree.leaves(jax.tree.map(np.asarray,
                                                         jsess.params))):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(float(got["loss"]),
                                       float(want["loss"]), rtol=TOL)
    assert int(sess.sync_state[NUMERICS_KEY]["step"]) == 4
    _assert_params_close(sess.params, jax.tree.map(np.asarray,
                                                   jsess.params))


def test_static_loss_scale_reports_the_unscaled_loss():
    batch = _batches(1)[0]
    plain = _port_session(AllReduce(bucket_bytes=1 << 20), None)
    ref = float(plain.run(batch)["loss"])
    for builder in (AllReduce(bucket_bytes=1 << 20), AllReduce()):
        scaled = _port_session(builder, {"loss_scale": 1024.0})
        out = scaled.run(batch)
        np.testing.assert_allclose(float(out["loss"]), ref, rtol=1e-5)
        assert float(out["grad_health"].loss_scale) == 1024.0
    jsess = _jax_session(JAllReduce(bucket_bytes=1 << 20),
                         {"loss_scale": 1024.0})
    np.testing.assert_allclose(float(jsess.run(batch)["loss"]), ref,
                               rtol=1e-5)
    _assert_params_close(scaled.params, jax.tree.map(np.asarray,
                                                     jsess.params))


def test_dynamic_loss_scale_backs_off_and_grows_as_in_jax():
    """The JAX package's ``test_loss_scale_backoff_and_growth`` schedule,
    with the NaN step given by the batch: 4, 4, 2, 2, 4."""
    scale = LossScale(init=4.0, growth_factor=2.0, backoff_factor=0.5,
                      growth_interval=2, min_scale=0.25)
    sess = _port_session(Zero1(bucket_bytes=1 << 20),
                         {"loss_scale": scale}, "fusable_adam")
    scales, skipped = [], []
    for b in _batches(5, poison_at=1):
        h = sess.run(b)["grad_health"]
        scales.append(float(h.loss_scale))
        skipped.append(int(h.skipped_steps))
    assert scales == [4.0, 4.0, 2.0, 2.0, 4.0]
    assert skipped == [0, 1, 1, 1, 1]


@pytest.mark.parametrize("spec,dtypes", [
    ("auto", ["float32"]), ("auto", ["float32", "bfloat16"]),
    ("auto", ["float16"]), (None, ["bfloat16"]), ("off", ["float16"]),
    (256.0, ["float32"]), (True, ["bfloat16"]),
    (LossScale(init=8.0), ["float32"])])
def test_resolve_loss_scale_matches_jax(spec, dtypes):
    jspec = jls.LossScale(init=8.0) if isinstance(spec, LossScale) else spec
    got, want = resolve_loss_scale(spec, dtypes), \
        jls.resolve_loss_scale(jspec, dtypes)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.init, got.dynamic, got.growth_interval) == \
            (want.init, want.dynamic, want.growth_interval)


@pytest.mark.parametrize("scale", [
    None, LossScale(init=8.0, growth_interval=2, min_scale=2.0,
                    max_scale=32.0),
    LossScale(init=16.0, dynamic=False)])
def test_update_state_sequence_matches_jax(scale):
    jscale = None if scale is None else jls.LossScale(
        **{f: getattr(scale, f) for f in scale.__dataclass_fields__})
    flags = [True, True, True, False, False, True, True, True, True, False,
             True, True, True]
    state, jstate = ls.init_state(scale), jls.init_state(jscale)
    for ok in flags:
        state = ls.update_state(state, torch.tensor(ok), scale)
        jstate = jls.update_state(jstate, jnp.bool_(ok), jscale)
        assert {k: v.item() for k, v in state.items()} == \
            {k: np.asarray(v).item() for k, v in jstate.items()}
        assert state["scale"].dtype == torch.float32
        assert state["skipped"].dtype == torch.int32


def test_numerics_config_coerce_matches_jax():
    for value in (None, False, True, "raise", {"clip_norm": 1.0},
                  {"loss_scale": None, "on_nonfinite": "rollback"}):
        got, want = NumericsConfig.coerce(value), \
            JNumericsConfig.coerce(value)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.__dict__ == want.__dict__
    for bad in ("explode", {"clip_norm": -1.0}, 3):
        with pytest.raises(ValueError):
            NumericsConfig.coerce(bad)


def test_wire_rules_match_jax():
    from autodist_tpu_torch.numerics import (scale_saturates_wire,
                                             wire_dtype_of)
    from autodist_tpu_torch.numerics.guard import wire_saturation

    for comp in ("NoneCompressor", "HorovodCompressor", "Int8Compressor"):
        assert wire_dtype_of(comp) == jls.wire_dtype_of(comp)
        for s in (None, LossScale(), LossScale(init=2.0, dynamic=False)):
            js = None if s is None else jls.LossScale(init=s.init,
                                                      dynamic=s.dynamic)
            assert (scale_saturates_wire(s, comp) is None) == \
                (jls.scale_saturates_wire(js, comp) is None)
    from autodist_tpu.numerics.guard import \
        wire_saturation as jwire_saturation

    for values in ([1.0, 3.4e38, np.nan], [1.0, 3e38, np.nan], [1.0]):
        x = np.array(values, np.float32)
        got = wire_saturation(torch.from_numpy(x), "bfloat16")
        assert bool(got) == bool(jwire_saturation(jnp.asarray(x),
                                                  "bfloat16"))
        assert bool(got) == (values[1:2] == [3.4e38])
    assert wire_saturation(torch.ones(2), None) is None


def test_health_accumulator_fused_and_unfused_agree():
    rng = np.random.default_rng(4)
    vals = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for n in (10, 300)]
    out = []
    for fused in (False, True):
        h = HealthAccumulator(1, fused=fused)
        h.add("a", vals[0])
        h.add("b", vals[1], finite_src=vals[1].clone())
        out.append(h.finalize(None, torch.tensor(1.5),
                              torch.tensor(0.5)))
    (fa, fn, fpb), (ua, un, upb) = out
    assert bool(fa) and bool(ua) and list(fpb) == list(upb) == ["a", "b"]
    torch.testing.assert_close(fn, un, rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(fn) ** 2, 0.25 * sum(
        float((v.double() ** 2).sum()) for v in vals), rtol=1e-6)
    h = HealthAccumulator(1, fused=True)
    h.add("a", vals[0])
    bad, _, pb = h.finalize(None, torch.tensor(float("nan")),
                            torch.tensor(1.0))
    assert not bool(bad) and bool(pb["a"]["finite"])
