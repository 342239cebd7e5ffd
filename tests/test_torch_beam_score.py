"""The port generator's ``beam_search`` and ``score`` against the JAX
generator's on the same weights (``tests/test_generate.py``'s oracles).

Beam tokens are exact against JAX's beam search at widths 1 and 4 (f32 and
int8 trees), beam width 1 equals greedy decode, and the beam logprob is
the returned sequence's score under the full forward at rtol/atol 1e-4
(the JAX test's tolerance).  ``score`` equals JAX's at rtol 1e-5 (f32,
another summation order), its mean NLL equals ``loss_fn`` at rtol 2e-4
(the JAX test's), and it equals the decode logits' log-softmax sum at
rtol 1e-4.
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
from autodist_tpu_torch.models.generate import make_generator
from autodist_tpu_torch.models.transformer_lm import transformer_lm

pytestmark = pytest.mark.torch_port

VOCAB = 97
CFG = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
           max_len=24, seq_len=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread, so parallel test workers do not
    contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lm():
    jspec = jlm(**CFG, attn_fn=jdense)
    jparams = jspec.init(jax.random.PRNGKey(0))
    spec = transformer_lm(**CFG)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jspec, jparams, spec, params


@pytest.mark.parametrize("tree", ["f32", "int8"])
@pytest.mark.parametrize("beams", [1, 4])
def test_beam_search_matches_jax(lm, tree, beams):
    jspec, jparams, spec, params = lm
    if tree == "int8":
        jparams = jquantize.quantize_lm_params(jparams)
        params = quantize.quantize_lm_params(params)
    prompt = np.random.RandomState(5).randint(0, VOCAB, (3, 4)) \
        .astype(np.int32)
    jtok, jlp = jmake_generator(jspec).beam_search(jparams, prompt, 6,
                                                   num_beams=beams)
    gen = make_generator(spec, device="cpu")
    tok, lp = gen.beam_search(params, prompt, 6, num_beams=beams)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-4,
                               atol=1e-4)
    if beams == 1:
        np.testing.assert_array_equal(tok.numpy(),
                                      gen(params, prompt, 6).numpy())


def test_beam_logprob_is_true_sequence_score(lm):
    _, _, spec, params = lm
    prompt = np.array([[11, 23]], np.int32)
    new = 5
    tokens, lp = make_generator(spec, device="cpu").beam_search(
        params, prompt, new, num_beams=3)
    logp = torch.log_softmax(spec.apply_fn(params, tokens).float(), dim=-1)
    p = prompt.shape[1]
    total = sum(float(logp[0, p - 1 + i, tokens[0, p + i]])
                for i in range(new))
    np.testing.assert_allclose(float(lp[0]), total, rtol=1e-4, atol=1e-4)


def test_score_matches_jax_loss_and_decode_logits(lm):
    jspec, jparams, spec, params = lm
    tokens = np.random.RandomState(13).randint(0, VOCAB, (4, 12)) \
        .astype(np.int32)
    gen = make_generator(spec, device="cpu")
    ll, ppl = gen.score(params, tokens)
    jll, jppl = jmake_generator(jspec).score(jparams, tokens)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=1e-5)
    np.testing.assert_allclose(ppl.numpy(), np.asarray(jppl), rtol=1e-5)
    t = tokens.shape[1] - 1
    np.testing.assert_allclose(float(-ll.mean() / t),
                               float(spec.loss_fn(params,
                                                  {"tokens": tokens})),
                               rtol=2e-4)
    np.testing.assert_allclose(ppl.numpy(), np.exp(-ll.numpy() / t),
                               rtol=1e-6)
    # teacher-forced decode logits: positions 0..T-2 predict tokens 1..T-1
    forced = torch.log_softmax(
        gen.with_logits(params, tokens, 1)[1][:t].float(), dim=-1)
    want = forced.gather(-1, torch.as_tensor(tokens[:, 1:].T).long()[..., None])
    np.testing.assert_allclose(ll.numpy(), want[..., 0].sum(0).numpy(),
                               rtol=1e-4)


def test_validation_matches_jax(lm):
    _, _, spec, params = lm
    gen = make_generator(spec, device="cpu")
    prompt = np.zeros((1, 2), np.int32)
    for bad in (0, VOCAB + 1):
        with pytest.raises(ValueError, match="num_beams"):
            gen.beam_search(params, prompt, 4, num_beams=bad)
    _, lp = gen.beam_search(params, prompt, 1, num_beams=VOCAB)
    assert np.isfinite(float(lp[0])) and float(lp[0]) > -1e6
    with pytest.raises(ValueError, match="length >= 2"):
        gen.score(params, np.zeros((2, 1), np.int32))
    with pytest.raises(ValueError, match="full-precision"):
        gen.score(quantize.quantize_lm_params(params),
                  np.zeros((2, 3), np.int32))
