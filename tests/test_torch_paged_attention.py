"""paged_attention: the port's plain version against the JAX Pallas kernel
run in interpret mode, plus the wrapper's input contract.

Tolerance: atol/rtol 1e-5, the JAX package's own test of its kernel
(``tests/test_fused_kernels.py``).  The CUDA kernel is held against the
plain version on the card (``tests/test_torch_cuda.py``, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.ops import fused_kernels as jfk
from autodist_tpu_torch.ops import fused_kernels as fk

pytestmark = pytest.mark.torch_port


def _inputs(seed=21, b=3, h=2, dh=16, nb=12, bs=4, maxb=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kc = rng.standard_normal((nb, bs, h, dh)).astype(np.float32)
    vc = rng.standard_normal((nb, bs, h, dh)).astype(np.float32)
    bt = rng.integers(1, nb, (b, maxb)).astype(np.int32)
    return q, kc, vc, bt


@pytest.mark.parametrize("rel_spec", ["varied", "first", "full"])
def test_plain_version_matches_jax_kernel(rel_spec):
    q, kc, vc, bt = _inputs()
    b, maxb, bs = q.shape[0], bt.shape[1], kc.shape[1]
    rel = {"varied": np.array([0, 7, 19], np.int32),
           "first": np.zeros(b, np.int32),
           "full": np.full(b, maxb * bs - 1, np.int32)}[rel_spec]
    want = np.asarray(jfk.paged_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        jnp.asarray(rel), interpret=True))
    before = fk.paged_attention.calls
    got = fk.paged_attention(*(torch.from_numpy(a)
                               for a in (q, kc, vc, bt, rel)))
    assert fk.paged_attention.calls == before   # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_masked_positions_get_zero_weight():
    """Positions past rel must not matter: poisoning them (K and V)
    leaves the output bit-identical."""
    q, kc, vc, bt = (torch.from_numpy(a) for a in _inputs(seed=3))
    rel = torch.tensor([2, 9, 13], dtype=torch.int32)
    out = fk.paged_attention(q, kc, vc, bt, rel)
    kc2, vc2 = kc.clone(), vc.clone()
    bs = kc.shape[1]
    for b in range(q.shape[0]):
        for pos in range(int(rel[b]) + 1, bt.shape[1] * bs):
            blk, off = int(bt[b, pos // bs]), pos % bs
            if all(int(bt[c, p // bs]) != blk or p % bs != off
                   for c in range(q.shape[0])
                   for p in range(int(rel[c]) + 1)):
                kc2[blk, off] = 1e4
                vc2[blk, off] = -1e4
    torch.testing.assert_close(fk.paged_attention(q, kc2, vc2, bt, rel), out,
                               atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "index_dtype",
                                 "shape"])
def test_contract_is_checked_on_every_device(bad):
    q, kc, vc, bt = (torch.from_numpy(a) for a in _inputs())
    rel = torch.zeros(q.shape[0], dtype=torch.int32)
    if bad == "dtype":
        q = q.double()
    elif bad == "contiguity":
        kc = kc.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "index_dtype":
        bt = bt.long()
    else:
        rel = rel[:-1]
    with pytest.raises((TypeError, ValueError)):
        fk.paged_attention(q, kc, vc, bt, rel)
