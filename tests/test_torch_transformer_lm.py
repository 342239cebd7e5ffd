"""The port's transformer_lm against the JAX package on the same weights.

Weights come from the JAX ``spec.init`` and cross through
``autodist_tpu_torch.convert.params_from_jax``; inputs are numpy-seeded.
Tolerance: 1e-5 absolute in f32 (both sides sum in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.models import base as jbase
from autodist_tpu.models.transformer import dense_attention as jdense
from autodist_tpu.models.transformer_lm import transformer_lm as jlm
from autodist_tpu_torch.convert import params_from_jax, params_to_numpy
from autodist_tpu_torch.models import base
from autodist_tpu_torch.models.transformer import dense_attention, lecun_normal
from autodist_tpu_torch.models.transformer_lm import transformer_lm

pytestmark = pytest.mark.torch_port

VOCAB = 97
CFG = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
           max_len=48, seq_len=16)


@pytest.fixture(scope="module")
def models():
    jspec = jlm(**CFG, attn_fn=jdense)
    jparams = jspec.init(jax.random.PRNGKey(0))
    spec = transformer_lm(**CFG)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jspec, jparams, spec, params


def test_logits_match_jax(models):
    jspec, jparams, spec, params = models
    tokens = np.random.RandomState(0).randint(0, VOCAB, (3, 16)) \
        .astype(np.int32)
    want = np.asarray(jspec.apply_fn(jparams, tokens))
    got = spec.apply_fn(params, tokens).numpy()
    assert got.shape == want.shape == (3, 16, VOCAB)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_loss_matches_jax(models):
    jspec, jparams, spec, params = models
    batch = jspec.sample_batch(4, seed=3)
    want = float(jspec.loss_fn(jparams, batch))
    got = float(spec.loss_fn(params, batch))
    assert got == pytest.approx(want, abs=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_matches_jax(causal):
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 7, 3, 8).astype(np.float32) for _ in range(3))
    want = np.asarray(jdense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal))
    got = dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_layer_norm_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(4, 16).astype(np.float32) * 3 + 1
    scale = rng.randn(16).astype(np.float32)
    want = np.asarray(jbase.layer_norm(jnp.asarray(x), jnp.asarray(scale)))
    got = base.layer_norm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_converter_roundtrip_and_flat_names(models):
    _, jparams, _, params = models
    tree = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    flat = {"/".join(str(p.key) for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert "decoder/layers_0/attn/query/kernel" in flat
    from_flat = params_from_jax(flat)
    np.testing.assert_array_equal(
        from_flat["decoder"]["layers_1"]["mlp"]["wo"]["kernel"].numpy(),
        tree["decoder"]["layers_1"]["mlp"]["wo"]["kernel"])


def test_init_matches_jax_layout_and_is_seeded(models):
    jspec, jparams, spec, _ = models
    p0 = spec.init(0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), params_to_numpy(p0))
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), jparams)
    again = spec.init(0, device="cpu")
    np.testing.assert_array_equal(p0["embed"].numpy(),
                                  again["embed"].numpy())
    assert not np.array_equal(spec.init(1, device="cpu")["embed"].numpy(),
                              p0["embed"].numpy())
    np.testing.assert_array_equal(
        p0["decoder"]["ln_final"]["scale"].numpy(), 1.0)


def test_lecun_normal_statistics():
    gen = torch.Generator().manual_seed(0)
    w = lecun_normal((256, 512), 256, gen)
    assert w.std().item() == pytest.approx(1 / 16, rel=0.03)
    assert w.abs().max().item() <= 2 / 16 / 0.87962566103423978 + 1e-6
