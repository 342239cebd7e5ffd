"""The port's make_generator against the JAX generator on the same weights.

Greedy decode must be token-exact; the per-position logits agree at 1e-5
(f32, other summation order).  Full-precision and weight-only int8 trees.
Sampled decode is checked for validity only: ``jax.random`` and
``torch.Generator`` draw different numbers.
"""
import jax
import numpy as np
import pytest
import torch

from autodist_tpu.models import quantize as jquantize
from autodist_tpu.models.generate import make_generator as jmake_generator
from autodist_tpu.models.transformer import dense_attention as jdense
from autodist_tpu.models.transformer_lm import transformer_lm as jlm
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.models import quantize
from autodist_tpu_torch.models.generate import (_prefill_forward,
                                                make_generator,
                                                unpack_lm_params)
from autodist_tpu_torch.models.transformer_lm import transformer_lm

pytestmark = pytest.mark.torch_port

VOCAB = 97
CFG = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
           max_len=48, seq_len=16)


@pytest.fixture(scope="module")
def lm():
    jspec = jlm(**CFG, attn_fn=jdense)
    jparams = jspec.init(jax.random.PRNGKey(0))
    spec = transformer_lm(**CFG)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    prompt = np.random.RandomState(0).randint(0, VOCAB, (3, 6)) \
        .astype(np.int32)
    return jspec, jparams, spec, params, prompt


@pytest.mark.parametrize("tree", ["f32", "int8"])
def test_greedy_token_exact_with_logits(lm, tree):
    jspec, jparams, spec, params, prompt = lm
    if tree == "int8":
        jparams = jquantize.quantize_lm_params(jparams)
        params = quantize.quantize_lm_params(params)
    jtok, jlogits = jmake_generator(jspec).with_logits(jparams, prompt, 10)
    tok, logits = make_generator(spec, device="cpu").with_logits(
        params, prompt, 10)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert logits.shape == (6 + 10 - 1, 3, VOCAB)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)


def test_decode_logits_match_full_forward(lm):
    """Teacher-forced decode logits equal the parallel forward's."""
    _, _, spec, params, prompt = lm
    tok, logits = make_generator(spec, device="cpu").with_logits(
        params, prompt, 5)
    full = spec.apply_fn(params, tok)[:, :-1]           # [B, T-1, V]
    np.testing.assert_allclose(logits.permute(1, 0, 2).numpy(),
                               full.numpy(), atol=1e-5, rtol=0)


def test_eos_matches_jax(lm):
    jspec, jparams, spec, params, prompt = lm
    free = np.asarray(jmake_generator(jspec)(jparams, prompt, 8))
    eos = int(free[0, prompt.shape[1] + 2])
    want = np.asarray(jmake_generator(jspec)(jparams, prompt, 8,
                                             eos_id=eos))
    got = make_generator(spec, device="cpu")(params, prompt, 8, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, prompt.shape[1] + 2:] == eos).all()


@pytest.mark.parametrize("knobs", [dict(temperature=0.8),
                                   dict(temperature=1.0, top_k=5),
                                   dict(temperature=1.0, top_p=0.5)])
def test_sampled_decode_is_valid(lm, knobs):
    _, _, spec, params, prompt = lm
    gen = make_generator(spec, device="cpu")
    rng = torch.Generator().manual_seed(3)
    out = gen(params, prompt, 12, rng=rng, **knobs)
    assert out.shape == (3, 18)
    np.testing.assert_array_equal(out[:, :6].numpy(), prompt)
    assert ((out >= 0) & (out < VOCAB)).all()
    again = gen(params, prompt, 12, rng=torch.Generator().manual_seed(3),
                **knobs)
    np.testing.assert_array_equal(out.numpy(), again.numpy())
    if "top_k" in knobs:
        # every sampled token is among the top-k of its position
        _, logits = gen.with_logits(params, out[:, :-1], 1)
        for pos in range(6, 18):
            top = torch.topk(logits[pos - 1], 5).indices
            assert all(int(out[b, pos]) in top[b].tolist() for b in range(3))


def test_sampling_validation(lm):
    _, _, spec, params, prompt = lm
    gen = make_generator(spec, device="cpu")
    with pytest.raises(ValueError, match="rng"):
        gen(params, prompt, 2, temperature=0.5)
    with pytest.raises(ValueError, match="top_k"):
        gen(params, prompt, 2, top_k=3)
    with pytest.raises(ValueError, match="max_len"):
        gen(params, prompt, 48)
    with pytest.raises(ValueError, match="eos_id"):
        gen(params, prompt, 2, eos_id=VOCAB)


def test_prefill_forward_matches_apply(lm):
    _, _, spec, params, prompt = lm
    embed, pos_embed, layers, ln_final = unpack_lm_params(params, 2)
    xs, ks, vs = _prefill_forward(layers, ln_final, embed, pos_embed,
                                  torch.from_numpy(prompt).long(), 2, 8)
    assert ks.shape == vs.shape == (2, 3, 6, 2, 8)
    logits = xs @ embed.t()
    np.testing.assert_allclose(logits.numpy(),
                               spec.apply_fn(params, prompt).numpy(),
                               atol=1e-6, rtol=0)
