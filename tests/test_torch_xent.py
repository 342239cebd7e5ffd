"""The port's vocabulary losses against their JAX twins on the CPU.

* ``chunked_softmax_cross_entropy`` on the cases of
  ``tests/test_chunked_xent.py`` (chunks that divide the vocabulary and
  ones that do not, lm1b's 6199-row factor, a chunk larger than the
  vocabulary, a leading shape, bf16 features) at that test's tolerances:
  rtol 1e-6 on the loss, rtol 1e-5 / atol 1e-7 on the gradients;
* ``sampled_softmax_cross_entropy`` with the negatives the JAX function
  draws, passed to the port explicitly: loss at rtol 1e-6, gradients at
  rtol 1e-5 / atol 1e-7, and ``dW`` zero outside the true and sampled rows;
* ``transformer_lm(xent_chunk=)`` against the JAX factory's chunked loss
  and the port's dense loss (``tests/test_models.py``'s check).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.ops.chunked_xent import \
    chunked_softmax_cross_entropy as jax_chunked
from autodist_tpu.ops.sampled_xent import \
    sampled_softmax_cross_entropy as jax_sampled
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.models.base import cross_entropy_loss
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops import (chunked_softmax_cross_entropy,
                                    sampled_softmax_cross_entropy)
from autodist_tpu_torch.ops.sampled_xent import draw_negatives

pytestmark = pytest.mark.torch_port


def _data(n=24, e=16, v=512, seed=0):
    """``tests/test_chunked_xent.py``'s inputs, as numpy."""
    rng = np.random.RandomState(seed)
    h = (rng.randn(n, e) * 0.5).astype(np.float32)
    w = (rng.randn(v, e) * 0.5).astype(np.float32)
    y = rng.randint(0, v, (n,)).astype(np.int32)
    return h, w, y


def _port(fn, h, w, y, dtype=torch.float32):
    """``fn``'s value and ``(dh, dw)`` on tensors of ``dtype``."""
    th = torch.tensor(h, dtype=dtype, requires_grad=True)
    tw = torch.tensor(w, dtype=dtype, requires_grad=True)
    loss = fn(th, tw, torch.from_numpy(y))
    dh, dw = torch.autograd.grad(loss, (th, tw))
    return float(loss.detach()), dh.float().numpy(), dw.float().numpy()


def _jax(fn, h, w, y, dtype=jnp.float32):
    value, (dh, dw) = jax.value_and_grad(fn, argnums=(0, 1))(
        jnp.asarray(h, dtype), jnp.asarray(w, dtype), jnp.asarray(y))
    return (float(value), np.asarray(dh.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _assert_match(got, want, rtol=1e-6, grad_rtol=1e-5, grad_atol=1e-7):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=grad_rtol, atol=grad_atol)


@pytest.mark.parametrize("v,chunk,n", [
    (512, 64, 24), (512, 128, 24), (512, 512, 24),
    (500, 128, 24),            # indivisible: the last chunk is short
    (6199, 512, 8),            # lm1b's 793472 = 128 x 6199
    (256, 8192, 24)],          # a chunk capped at the vocabulary
    ids=["c64", "c128", "c512", "indivisible", "lm1b_factor", "capped"])
def test_chunked_matches_jax(v, chunk, n):
    h, w, y = _data(n=n, e=4 if v == 6199 else 16, v=v)
    got = _port(lambda a, b, c: chunked_softmax_cross_entropy(
        a, b, c, chunk=chunk), h, w, y)
    want = _jax(lambda a, b, c: jax_chunked(a, b, c, chunk=chunk), h, w, y)
    _assert_match(got, want)


def test_chunked_matches_dense():
    h, w, y = _data()
    got = _port(lambda a, b, c: chunked_softmax_cross_entropy(
        a, b, c, chunk=128), h, w, y)
    want = _port(lambda a, b, c: cross_entropy_loss(a @ b.T, c), h, w, y)
    _assert_match(got, want)


def test_chunked_leading_shape_flattens():
    h, w, y = _data()
    flat = chunked_softmax_cross_entropy(torch.from_numpy(h),
                                         torch.from_numpy(w),
                                         torch.from_numpy(y), chunk=128)
    shaped = chunked_softmax_cross_entropy(
        torch.from_numpy(h).reshape(4, 6, -1), torch.from_numpy(w),
        torch.from_numpy(y).reshape(4, 6), chunk=128)
    np.testing.assert_allclose(float(shaped), float(flat), rtol=1e-7)


def test_chunked_bf16_features_accumulate_in_f32():
    """bf16 inputs, f32 logits: within the JAX test's rtol 2e-2 of the f32
    dense loss, gradients in the inputs' dtype."""
    h, w, y = _data()
    th = torch.tensor(h, dtype=torch.bfloat16, requires_grad=True)
    tw = torch.tensor(w, dtype=torch.bfloat16, requires_grad=True)
    loss = chunked_softmax_cross_entropy(th, tw, torch.from_numpy(y),
                                         chunk=128)
    dense = cross_entropy_loss(torch.from_numpy(h) @ torch.from_numpy(w).T,
                               torch.from_numpy(y))
    np.testing.assert_allclose(float(loss.detach()), float(dense), rtol=2e-2)
    dh, dw = torch.autograd.grad(loss, (th, tw))
    assert dh.dtype == dw.dtype == torch.bfloat16


def _jax_negatives(key, k, v):
    return np.array(jax.random.randint(key, (k,), 0, v))


@pytest.mark.parametrize("n,v,k,seed", [(64, 512, 64, 0), (8, 512, 16, 3),
                                        (24, 256, 200, 1)])
def test_sampled_matches_jax_with_its_negatives(n, v, k, seed):
    h, w, y = _data(n=n, v=v, seed=seed)
    key = jax.random.PRNGKey(seed)
    neg = torch.from_numpy(_jax_negatives(key, k, v))
    got = _port(lambda a, b, c: sampled_softmax_cross_entropy(a, b, c, neg),
                h, w, y)
    want = _jax(lambda a, b, c: jax_sampled(a, b, c, key, num_sampled=k),
                h, w, y)
    _assert_match(got, want)
    touched = set(neg.tolist()) | set(y.tolist())
    assert set(np.nonzero(np.abs(got[2]).sum(axis=1))[0].tolist()) <= touched


def test_sampled_masks_accidental_hits():
    """Every negative hits (vocab 1): only the true class remains."""
    loss = sampled_softmax_cross_entropy(
        torch.ones(4, 8), torch.ones(1, 8), torch.zeros(4, dtype=torch.long),
        torch.zeros(4, dtype=torch.long))
    assert float(loss) == pytest.approx(0.0, abs=1e-6)


def test_draw_negatives_is_seeded_and_in_range():
    a = draw_negatives(7, 64, 1000)
    assert torch.equal(a, draw_negatives(7, 64, 1000))
    assert not torch.equal(a, draw_negatives(8, 64, 1000))
    assert a.shape == (64,) and 0 <= int(a.min()) and int(a.max()) < 1000
    assert draw_negatives(7, 64, 10).shape == (10,)     # k capped at V


LM_KW = dict(vocab_size=250, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
             max_len=16, seq_len=16)


def test_transformer_lm_chunked_matches_jax_and_dense():
    """``transformer_lm(xent_chunk=128)`` on the JAX factory's weights: the
    same tree, its loss and gradients equal the JAX chunked loss's (rtol
    1e-5 / atol 1e-6) and the port's dense loss (rtol 1e-5)."""
    jspec = jax_lm(**LM_KW, attn_fn=jax_dense, xent_chunk=128)
    params = jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    batch = jspec.sample_batch(4)
    chunked = transformer_lm(**LM_KW, xent_chunk=128)
    dense = transformer_lm(**LM_KW)
    assert {n: tuple(x.shape) for n, x in flatten(chunked.init(
        0, device="cpu"))} == {n: x.shape for n, x in flatten(params)}
    jloss, jgrads = jax.value_and_grad(jspec.loss_fn)(params, batch)
    jgrads = dict(flatten(jax.tree.map(np.asarray, jgrads)))
    results = {}
    for name, spec in (("chunked", chunked), ("dense", dense)):
        tree = params_from_jax(params)
        leaves = dict(flatten(tree))
        for x in leaves.values():
            x.requires_grad_(True)
        loss = spec.loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        results[name] = (float(loss.detach()), dict(zip(leaves, grads)))
    np.testing.assert_allclose(results["chunked"][0], float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(results["chunked"][0], results["dense"][0],
                               rtol=1e-5)
    for n, g in results["chunked"][1].items():
        np.testing.assert_allclose(g.numpy(), jgrads[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)
        np.testing.assert_allclose(g.numpy(), results["dense"][1][n].numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=n)
