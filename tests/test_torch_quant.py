"""Weight-only int8: the port's quantizer and int8_matmul against the JAX
package (its Pallas kernel in interpret mode).

``quantize_weight`` must be bit-equal (same round-half-even, same scale
rule); ``int8_matmul`` agrees at rtol 1e-5 / atol 1e-4, the JAX package's
own tolerance (``tests/test_quant.py``): f32 sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.models import quantize as jquantize
from autodist_tpu.models.transformer import dense_attention as jdense
from autodist_tpu.models.transformer_lm import transformer_lm as jlm
from autodist_tpu.ops import quant as jquant
from autodist_tpu_torch.convert import params_from_jax, params_to_numpy
from autodist_tpu_torch.models import quantize
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops import quant

pytestmark = pytest.mark.torch_port


def test_quantize_weight_bit_equal_with_zero_column():
    rng = np.random.RandomState(0)
    w = (rng.randn(64, 40) * 3).astype(np.float32)
    w[:, 7] = 0.0                                   # all-zero column
    jw = jquant.quantize_weight(jnp.asarray(w))
    tw = quant.quantize_weight(torch.from_numpy(w))
    assert tw.q.dtype == torch.int8 and tuple(tw.scale.shape) == (1, 40)
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    assert tw.scale[0, 7].item() == 1.0
    assert not tw.q[:, 7].any()


def test_quantize_weight_ties_round_half_even():
    """Values landing exactly on .5 of the grid round to even in both."""
    w = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]], np.float32).T
    w = np.concatenate([w, w], axis=1)
    jw = jquant.quantize_weight(jnp.asarray(w))
    tw = quant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))


def test_quantize_weight_rejects_non_2d():
    with pytest.raises(ValueError, match="2-D"):
        quant.quantize_weight(torch.zeros(2, 3, 4))


@pytest.mark.parametrize("m,k,n", [(5, 64, 40), (8, 128, 512),
                                   (1, 96, 1000), (16, 256, 513)])
def test_int8_matmul_matches_jax_kernel(m, k, n):
    rng = np.random.RandomState(1)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(w))
    want = np.asarray(jquant.int8_matmul(jnp.asarray(x), jw, interpret=True))
    tw = quant.Quantized(torch.from_numpy(np.array(jw.q)),
                         torch.from_numpy(np.array(jw.scale)))
    got = quant.int8_matmul(torch.from_numpy(x), tw)
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_int8_matmul_leading_dims_and_contract():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 32).astype(np.float32)
    w = rng.randn(32, 16).astype(np.float32)
    want = np.asarray(jquant.int8_matmul(
        jnp.asarray(x), jquant.quantize_weight(jnp.asarray(w)),
        interpret=True))
    tw = quant.quantize_weight(torch.from_numpy(w))
    got = quant.int8_matmul(torch.from_numpy(x), tw)
    assert got.shape == (2, 3, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="contraction mismatch"):
        quant.int8_matmul(torch.zeros(2, 31), tw)
    with pytest.raises(ValueError, match="contiguous"):
        quant.int8_matmul(torch.zeros(32, 4).t(), tw)
    with pytest.raises(TypeError, match="float32"):
        quant.int8_matmul(torch.zeros(2, 32, dtype=torch.float64), tw)


@pytest.fixture(scope="module")
def lm():
    cfg = dict(vocab_size=96, num_layers=2, num_heads=2, head_dim=8,
               d_ff=32, max_len=32, seq_len=32)
    jspec = jlm(**cfg, attn_fn=jdense)
    jparams = jspec.init(jax.random.PRNGKey(0))
    return jspec, jparams, transformer_lm(**cfg), params_from_jax(
        jax.tree.map(np.asarray, jparams))


def test_quantize_lm_params_bit_equal(lm):
    jspec, jparams, spec, params = lm
    jq = jax.tree.map(np.asarray, jquantize.quantize_lm_params(jparams))
    tq = params_to_numpy(quantize.quantize_lm_params(params))
    assert len(jax.tree.leaves(tq)) == len(jax.tree.leaves(jq))
    for a, b in zip(jax.tree.leaves(tq), jax.tree.leaves(jq)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert quantize.is_quantized(quantize.quantize_lm_params(params))
    assert not quantize.is_quantized(params)


def test_dequantize_and_converted_int8_tree(lm):
    jspec, jparams, spec, params = lm
    jq = jquantize.quantize_lm_params(jparams)
    # the JAX Quantized leaves cross the bridge as (q, scale) pairs
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    assert isinstance(tq["embed"], quant.Quantized)
    want = jax.tree.map(np.asarray, jquantize.dequantize_lm_params(jq, jspec))
    got = params_to_numpy(quantize.dequantize_lm_params(tq, spec))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_embed_lookup_and_head_logits_match_jax(lm):
    jspec, jparams, spec, params = lm
    jq = jquantize.quantize_lm_params(jparams)
    tq = quantize.quantize_lm_params(params)
    tok = np.array([[3, 95, 0], [7, 7, 50]], np.int32)
    np.testing.assert_allclose(
        quantize.embed_lookup(tq["embed"], torch.from_numpy(tok),
                              torch.float32).numpy(),
        np.asarray(jquantize.embed_lookup(jq["embed"], jnp.asarray(tok),
                                          jnp.float32)), atol=0, rtol=0)
    x = np.random.RandomState(3).randn(4, 16).astype(np.float32)
    np.testing.assert_allclose(
        quantize.head_logits(tq["embed"], torch.from_numpy(x)).numpy(),
        np.asarray(jquantize.head_logits(jq["embed"], jnp.asarray(x))),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        quantize.head_logits(params["embed"], torch.from_numpy(x)).numpy(),
        np.asarray(jquantize.head_logits(jparams["embed"], jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
