"""The port's flash attention (CPU plain path through the autograd
Function) against the JAX package's Pallas flash kernels in interpret
mode, and the backend rule of ``default_attention``.

Inputs are numpy-seeded and shared by both sides.  Tolerances are the JAX
package's own flash tests': 1e-5 on outputs and lse, 1e-4 on gradients.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.ops.flash_attention import \
    flash_attention_with_lse as jflash_lse
from autodist_tpu_torch.models.transformer import (default_attention,
                                                   dense_attention)

fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
jfa = importlib.import_module("autodist_tpu.ops.flash_attention")

pytestmark = pytest.mark.torch_port


def _inputs(seed, b=2, t=32, h=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, t, h, d),) * 4 + ((b, h, t),)]


@pytest.mark.parametrize("t", [32, 23])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_with_lse_and_grads_match_jax_interpret(causal, t):
    q, k, v, w, wl = _inputs(t + causal, t=t)

    def jloss(q, k, v):
        o, lse = jflash_lse(q, k, v, causal, block_q=8, block_k=8,
                            interpret=True)
        return jnp.sum(o * w) + jnp.sum(lse * wl)

    jo, jlse = jflash_lse(q, k, v, causal, block_q=8, block_k=8,
                          interpret=True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    before = fa.flash_attention.fwd_calls
    o, lse = fa.flash_attention_with_lse(tq, tk, tv, causal)
    ((o * torch.tensor(w)).sum() + (lse * torch.tensor(wl)).sum()).backward()
    assert fa.flash_attention.fwd_calls == before   # CPU: plain versions
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               rtol=1e-5, atol=1e-5)
    for got, want, name in zip((tq, tk, tv), jgrads, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=f"d{name}")
    out = fa.flash_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), causal)
    np.testing.assert_array_equal(out.numpy(), o.detach().numpy())


def _jax_private(q, k, v, do, dlse, causal, t):
    """JAX ``_fwd`` / ``_bwd`` on inputs padded to a multiple of 8 with the
    true ``kv_len = t`` (the masked-padding branch of all three kernels),
    sliced back to ``[B, T, H, D]`` and ``[B, H, T]``."""
    tp = -(-t // 8) * 8
    pad = [(0, 0), (0, 0), (0, tp - t), (0, 0)]
    qt, kt, vt, dot = (jnp.pad(jnp.asarray(x).transpose(0, 2, 1, 3), pad)
                       for x in (q, k, v, do))
    o, lse = jfa._fwd(qt, kt, vt, causal, 8, 8, True, t)
    dl = jnp.pad(jnp.asarray(dlse), [(0, 0), (0, 0), (0, tp - t)])[..., None]
    dq, dk, dv = jfa._bwd(qt, kt, vt, o, lse, dot, causal, 8, 8, True, t,
                          dlse=dl)
    back = lambda x: np.asarray(x[:, :, :t]).transpose(0, 2, 1, 3)  # noqa
    return back(o), np.asarray(lse[:, :, :t, 0]), back(dq), back(dk), back(dv)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_versions_match_jax_private_kernels_with_padding(causal):
    t = 21
    q, k, v, do, dlse = _inputs(7 + causal, t=t, d=8)
    jo, jlse, jdq, jdk, jdv = _jax_private(q, k, v, do, dlse, causal, t)
    tq, tk, tv, tdo, tdl = map(torch.tensor, (q, k, v, do, dlse))
    o, lse = fa.flash_fwd_reference(tq, tk, tv, causal)
    np.testing.assert_allclose(o.numpy(), jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=1e-5, atol=1e-5)
    delta = ((tdo * o).sum(-1).transpose(1, 2) - tdl).contiguous()
    args = (tq, tk, tv, tdo, lse, delta, causal)
    np.testing.assert_allclose(fa.flash_dq_reference(*args).numpy(), jdq,
                               rtol=1e-4, atol=1e-4)
    dk, dv = fa.flash_dkv_reference(*args)
    np.testing.assert_allclose(dk.numpy(), jdk, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dv.numpy(), jdv, rtol=1e-4, atol=1e-4)
    # the wrappers take the plain versions for CPU tensors
    np.testing.assert_array_equal(fa.flash_dq(*args).numpy(),
                                  fa.flash_dq_reference(*args).numpy())


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_match_dense_attention(causal):
    q, k, v, w, _ = _inputs(11, t=17, d=8)
    grads = {}
    for name, attn in (("flash", fa.flash_attention),
                       ("dense", dense_attention)):
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        (attn(*ts, causal) * torch.tensor(w)).sum().backward()
        grads[name] = [x.grad.numpy() for x in ts]
    for gf, gd in zip(grads["flash"], grads["dense"]):
        np.testing.assert_allclose(gf, gd, rtol=1e-4, atol=1e-4)


def test_default_attention_is_dense_on_cpu_and_flash_on_cuda(monkeypatch):
    q, k, v, _, _ = _inputs(3, t=9, d=8)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    before = fa.flash_attention.fwd_calls
    np.testing.assert_array_equal(
        default_attention()(tq, tk, tv, True).numpy(),
        dense_attention(tq, tk, tv, True).numpy())
    assert fa.flash_attention.fwd_calls == before

    class OnCuda:                   # stands in for a CUDA tensor
        device = torch.device("cuda")

    monkeypatch.setattr(fa, "flash_attention",
                        lambda q, k, v, causal: ("flash", causal))
    assert default_attention()(OnCuda(), None, None, True) == ("flash", True)


def test_contract_is_checked_on_the_cpu_too():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="bf16 flash"):
        fa.flash_attention(x.bfloat16(), x.bfloat16(), x.bfloat16())
    with pytest.raises(TypeError):
        fa.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention(x.double(), x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.zeros(1, 2, 4, 8).transpose(1, 2)
        fa.flash_attention(y, y, y)
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(1, 4, 2, 24)
        fa.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="differs"):
        fa.flash_attention(x, x, torch.zeros(1, 5, 2, 8))
