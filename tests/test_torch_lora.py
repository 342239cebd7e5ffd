"""LoRA in the port against the JAX package (``tests/test_lora.py``).

The JAX adapters (their threefry init included) are carried across with
``convert.lora_from_jax``.  Merged trees equal JAX's at rtol 1e-6 (the
JAX test's merge tolerance), finetuning through the facade with the base
frozen gives JAX's losses at rtol 1e-5 step by step with the base
bit-identical, and a merged LM decodes token-exact against the JAX
generator on JAX's merged tree.
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
from autodist_tpu.mesh import build_mesh as jax_build_mesh
from autodist_tpu.models import lora as jlora
from autodist_tpu.models.generate import make_generator as jmake_generator
from autodist_tpu.models.transformer import dense_attention as jdense
from autodist_tpu.models.transformer_lm import transformer_lm as jlm
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu.strategy import PSLoadBalancing as JPSLoadBalancing
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.convert import lora_from_jax, params_from_jax
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.models import lora_init, lora_merge, lora_setup
from autodist_tpu_torch.models.generate import make_generator
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.strategy import AllReduce, PSLoadBalancing

pytestmark = pytest.mark.torch_port

LM = dict(vocab_size=61, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
          max_len=32, seq_len=16)
#: the JAX test's LM targets: attention out split at 2, then q/k/v, MLP
LM_TARGETS = [("*/attn/out/*", 2), "*/attn/*", "*/mlp/*"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread, so parallel test workers do not
    contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")


def _toy_params(rng):
    return {"enc": {"w1": rng.randn(6, 8).astype(np.float32),
                    "b1": np.zeros((8,), np.float32)},
            "head": {"w2": rng.randn(8, 3).astype(np.float32)}}


def _jax_toy_loss(p, b):
    h = jnp.tanh(b["x"] @ p["enc"]["w1"] + p["enc"]["b1"])
    return jnp.mean((h @ p["head"]["w2"] - b["y"]) ** 2)


def _toy_loss(p, b):
    x, y = (torch.as_tensor(b[k]) for k in ("x", "y"))
    h = torch.tanh(x @ p["enc"]["w1"] + p["enc"]["b1"])
    return torch.mean((h @ p["head"]["w2"] - y) ** 2)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def test_init_targets_names_and_validation():
    params = params_from_jax(_toy_params(np.random.RandomState(0)))
    gen = torch.Generator().manual_seed(0)
    ad = lora_init(gen, params, rank=4)
    jad = jlora.lora_init(jax.random.PRNGKey(0),
                          _toy_params(np.random.RandomState(0)), rank=4)
    assert set(ad) == set(jad) == {"enc.w1", "head.w2"}
    for name in ad:
        for k in ("a", "b"):
            assert tuple(ad[name][k].shape) == jad[name][k].shape
        assert not ad[name]["b"].any()
    assert set(lora_init(gen, params, rank=2, targets=("head",))) \
        == {"head.w2"}
    for kw, msg in (({"targets": ("enc/b1",)}, "2 dims"),
                    ({"targets": ("nope",)}, "matched"),
                    ({"targets": [("enc/w1", 2)]}, "split"),
                    ({"rank": 0}, "rank")):
        with pytest.raises(ValueError, match=msg):
            lora_init(gen, params, **{"rank": 2, **kw})
    with pytest.raises(ValueError, match="pair"):
        lora_from_jax({"enc.w1": {"a": np.zeros((6, 2))}})


def test_merge_math_matches_jax():
    rng = np.random.RandomState(1)
    jparams = _toy_params(rng)
    jad = jlora.lora_init(jax.random.PRNGKey(1), jparams, rank=4)
    params = params_from_jax(jparams)
    ad = lora_from_jax(_numpy(jad))
    merged = lora_merge(params, ad, alpha=8.0, rank=4)
    for name, leaf in flatten(merged):                  # B = 0: exact
        np.testing.assert_array_equal(
            leaf.numpy(), dict(flatten(params))[name].numpy())
    jad["enc.w1"]["b"] = jnp.asarray(rng.randn(4, 8), jnp.float32)
    ad = lora_from_jax(_numpy(jad))
    got = dict(flatten(lora_merge(params, ad, alpha=8.0, rank=4)))
    want = dict(flatten(_numpy(jlora.lora_merge(jparams, jad, alpha=8.0,
                                                rank=4))))
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name],
                                   rtol=1e-6, err_msg=name)


def test_lm_merged_tree_carried_from_jax():
    """The transformer LM's adapters from the JAX init with random B:
    the port's merged tree equals JAX's at rtol 1e-6 leaf by leaf."""
    jspec = jlm(**LM, attn_fn=jdense)
    jparams = jspec.init(jax.random.PRNGKey(0))
    jad = jlora.lora_init(jax.random.PRNGKey(3), jparams, rank=2,
                          targets=LM_TARGETS)
    rng = np.random.RandomState(4)
    for pair in jad.values():
        pair["b"] = jnp.asarray(rng.randn(*pair["b"].shape) * 0.1,
                                jnp.float32)
    want = dict(flatten(_numpy(jlora.lora_merge(jparams, jad, alpha=4.0,
                                                rank=2))))
    got = dict(flatten(lora_merge(params_from_jax(_numpy(jparams)),
                                  lora_from_jax(_numpy(jad)), alpha=4.0,
                                  rank=2)))
    assert set(got) == set(want) and len(jad) == 2 * 6
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name],
                                   rtol=1e-6, err_msg=name)


def _jax_session(setup, builder, optimizer):
    jax_reset()
    ad = JAutoDist(strategy_builder=builder)
    with ad.scope():
        ad.capture(**setup.capture_args, optimizer=optimizer)
    return ad.create_distributed_session(
        mesh=jax_build_mesh(devices=jax.devices()[:1]))


def _port_session(setup, builder, optimizer):
    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(**setup.capture_args, optimizer=optimizer)
    return ad.create_distributed_session()


def _carried_setup(jsetup, params, loss_fn, **kw):
    """The port's setup with the JAX setup's adapters in place of its
    own draw."""
    setup = lora_setup(params, loss_fn, rng=torch.Generator(), **kw)
    setup.capture_args["params"]["lora"] = lora_from_jax(
        _numpy(jsetup.capture_args["params"]["lora"]))
    return setup


@pytest.mark.parametrize("builder", ["AllReduce", "PSLoadBalancing"])
def test_toy_finetune_matches_jax_with_the_base_frozen(builder):
    rng = np.random.RandomState(2)
    jparams = _toy_params(rng)
    batch = {"x": rng.randn(16, 6).astype(np.float32),
             "y": rng.randn(16, 3).astype(np.float32)}
    jsetup = jlora.lora_setup(jparams, _jax_toy_loss,
                              rng=jax.random.PRNGKey(2), rank=4)
    params = params_from_jax(jparams)
    setup = _carried_setup(jsetup, params, _toy_loss, rank=4)
    jsess = _jax_session(jsetup, {"AllReduce": JAllReduce,
                                  "PSLoadBalancing": JPSLoadBalancing}
                         [builder](), optax.adamw(5e-2))
    sess = _port_session(setup, {"AllReduce": AllReduce,
                                 "PSLoadBalancing": PSLoadBalancing}
                         [builder](), optim.adamw(5e-2))
    jl = [float(jsess.run(batch)["loss"]) for _ in range(20)]
    pl = [float(sess.run(batch)["loss"]) for _ in range(20)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0] * 0.9
    after = sess.device_params
    for name, leaf in flatten(sess.params["base"]):
        np.testing.assert_array_equal(leaf, dict(flatten(params))[name],
                                      err_msg=name)
    base_shapes = {tuple(x.shape) for _, x in flatten(params)
                   if x.dim() == 2}
    opt_shapes = [tuple(x.shape) for _, x in flatten(sess.opt_state)
                  if hasattr(x, "shape") and x.dim()]
    assert not base_shapes & set(opt_shapes), opt_shapes
    merged = setup.merge(after)
    np.testing.assert_allclose(
        float(_toy_loss(merged, batch)),
        float(setup.capture_args["loss_fn"](after, batch).detach()),
        rtol=1e-5)


def test_lm_finetune_matches_jax_and_merged_tree_decodes():
    jspec = jlm(**LM, attn_fn=jdense)
    jparams = jspec.init(jax.random.PRNGKey(0))
    spec = transformer_lm(**LM)
    params = params_from_jax(_numpy(jparams))
    jsetup = jlora.lora_setup(jparams, jspec.loss_fn,
                              rng=jax.random.PRNGKey(3), rank=2,
                              targets=LM_TARGETS)
    setup = _carried_setup(jsetup, params, spec.loss_fn, rank=2,
                           targets=LM_TARGETS)
    assert setup.num_adapter_params == jsetup.num_adapter_params
    batch = spec.sample_batch(8)
    jsess = _jax_session(jsetup, JAllReduce(), optax.adam(1e-2))
    sess = _port_session(setup, AllReduce(), optim.adam(1e-2))
    jl = [float(jsess.run(batch)["loss"]) for _ in range(6)]
    pl = [float(sess.run(batch)["loss"]) for _ in range(6)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    merged = setup.merge(sess.params)
    jmerged = jsetup.merge(jsess.params)
    prompt = np.random.RandomState(5).randint(0, 61, (2, 3))
    np.testing.assert_array_equal(
        make_generator(spec, device="cpu")(merged, prompt, 6).numpy(),
        np.asarray(jmake_generator(jspec)(jmerged, prompt, 6)))
    for name, leaf in flatten(sess.params["base"]):
        np.testing.assert_array_equal(leaf, dict(flatten(params))[name],
                                      err_msg=name)


def test_port_init_trains_through_the_facade():
    """The port's own draw (a torch.Generator): losses fall and the
    merged tree serves through the generator."""
    spec = transformer_lm(**LM)
    params = spec.init(0, device="cpu")
    setup = lora_setup(params, spec.loss_fn,
                       rng=torch.Generator().manual_seed(0), rank=2,
                       targets=LM_TARGETS)
    sess = _port_session(setup, AllReduce(), optim.adam(1e-2))
    batch = spec.sample_batch(8)
    losses = [float(sess.run(batch)["loss"]) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    toks = make_generator(spec, device="cpu")(setup.merge(sess.params),
                                              np.zeros((1, 2)), 4)
    assert toks.shape == (1, 6)
