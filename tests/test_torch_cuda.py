"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels
from ``autodist_tpu_torch/csrc``) and skip elsewhere.  The file imports
nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: paged attention atol/rtol 1e-5 (the JAX kernel test's);
int8 matmul rtol 1e-5 / atol 1e-4 (the JAX int8 test's), at the model's
magnitudes (unit-variance activations, weights of std 1/sqrt(K)).
"""
import numpy as np
import pytest
import torch

from autodist_tpu_torch.ops import fused_kernels as fk
from autodist_tpu_torch.ops import quant

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("b,h,dh,bs,maxb", [(8, 12, 64, 32, 32),
                                            (3, 2, 16, 4, 5),
                                            (5, 3, 128, 16, 7),
                                            (1, 1, 40, 8, 3),
                                            (48, 12, 64, 8, 4)])
def test_paged_attention_kernel_matches_plain(dev, b, h, dh, bs, maxb):
    gen = torch.Generator().manual_seed(b * h + dh)
    nb = b * maxb + 1
    q = torch.randn(b, h, dh, generator=gen).to(dev)
    kc = torch.randn(nb, bs, h, dh, generator=gen).to(dev)
    vc = torch.randn(nb, bs, h, dh, generator=gen).to(dev)
    bt = torch.randint(0, nb, (b, maxb), generator=gen).to(dev, torch.int32)
    for rel in (torch.zeros(b), torch.full((b,), maxb * bs - 1),
                torch.randint(0, maxb * bs, (b,), generator=gen)):
        rel = rel.to(dev, torch.int32)
        before = fk.paged_attention.calls
        out = fk.paged_attention(q, kc, vc, bt, rel)
        torch.cuda.synchronize()
        assert fk.paged_attention.calls == before + 1
        torch.testing.assert_close(
            out, fk.paged_attention_reference(q, kc, vc, bt, rel),
            atol=1e-5, rtol=1e-5)


def test_paged_attention_kernel_rejects_what_it_cannot_take(dev):
    q = torch.randn(2, 2, 256, device=dev)
    kc = torch.randn(3, 4, 2, 256, device=dev)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    rel = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fk.paged_attention(q, kc, kc, bt, rel)
    q = torch.randn(2, 1, 2, 8, device=dev)[:, 0].transpose(0, 1)
    kc = torch.randn(3, 4, 2, 8, device=dev)
    with pytest.raises(ValueError):
        fk.paged_attention(q, kc, kc, bt, rel)


@pytest.mark.parametrize("m,k,n", [(1, 768, 768), (8, 768, 3072),
                                   (16, 3072, 768), (8, 768, 32128),
                                   (3, 100, 77), (2, 5, 130),
                                   (5, 4099, 1002), (17, 100, 77),
                                   (512, 768, 32128), (300, 257, 513)])
def test_int8_matmul_kernel_matches_plain(dev, m, k, n):
    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).to(dev)
    w = quant.quantize_weight((torch.randn(k, n, generator=gen)
                               / np.sqrt(k)).to(dev))
    before = quant.int8_matmul.calls
    out = quant.int8_matmul(x, w)
    torch.cuda.synchronize()
    assert quant.int8_matmul.calls == before + 1
    torch.testing.assert_close(out, quant.int8_matmul_reference(x, w),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("k,n", [(768, 3072), (3072, 768), (768, 32128)])
def test_int8_matmul_small_m_results_do_not_depend_on_m(dev, k, n):
    """Decode (M = slots) and the reference generator (M = 1) must see the
    same numbers for the same row: the skinny kernel's sum order does not
    depend on M."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(16, k, generator=gen).to(dev)
    w = quant.quantize_weight((torch.randn(k, n, generator=gen)
                               / np.sqrt(k)).to(dev))
    batched = quant.int8_matmul(x, w)
    for rows in (1, 3, 8):
        torch.testing.assert_close(quant.int8_matmul(x[:rows], w),
                                   batched[:rows], atol=0, rtol=0)
