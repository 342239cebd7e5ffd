"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels
from ``autodist_tpu_torch/csrc``) and skip elsewhere.  The file imports
nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: paged attention atol/rtol 1e-5 (the JAX kernel test's);
int8 matmul rtol 1e-5 / atol 1e-4 (the JAX int8 test's), at the model's
magnitudes (unit-variance activations, weights of std 1/sqrt(K)); flash
attention 1e-5 on o and lse, 1e-4 on gradients (the JAX flash tests');
the guard statistics K4: the count exactly, the sum of squares at rtol
1e-6 of an f64 sum; the Adam update K5 at atol 1e-6 (the JAX kernel
test's); the quantized-ring hop kernels K6–K8: payload bit-equal and
scales equal to the plain version's, error at atol 1e-6, saturation
counts equal (the JAX kernel test's, ``tests/test_fused_kernels.py:
148-199``); the tiny BASELINE models' steps on the card against the CPU:
losses at rtol 1e-5, parameters at atol 1e-4 (the gloo tests').
"""
import importlib

import numpy as np
import pytest
import torch

from autodist_tpu_torch.ops import fused_kernels as fk
from autodist_tpu_torch.ops import quant

# the module (the package's ``flash_attention`` attribute is the function)
fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
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


MODEL_KN = [(768, 768), (768, 3072), (3072, 768), (768, 32128)]


@pytest.mark.parametrize("m", [17, 64, 256, 2048])
@pytest.mark.parametrize("k,n", MODEL_KN)
def test_int8_matmul_kernels_at_prefill_shapes(dev, m, k, n):
    """Both kernels (the tiled one, and the skinny one in slabs of 16
    rows) at the prefill row counts of the model's four projections, at
    the unchanged tolerance."""
    gen = torch.Generator().manual_seed(m * 7 + k + n)
    x = torch.randn(m, k, generator=gen).to(dev)
    w = quant.quantize_weight((torch.randn(k, n, generator=gen)
                               / np.sqrt(k)).to(dev))
    want = quant.int8_matmul_reference(x, w)
    for path in ("tiled", "skinny"):
        out = quant._launch(x, w, path)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4,
                                   msg=path)


@pytest.mark.parametrize("k,n", MODEL_KN + [(100, 77), (4099, 1002)])
def test_int8_matmul_tiled_results_do_not_depend_on_m(dev, k, n):
    """Prefill rows see the same numbers however many rows share the
    launch: the tiled kernel sums K in one fixed order for every tile
    shape (M 17 and 512 take different tiles)."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(512, k, generator=gen).to(dev)
    w = quant.quantize_weight((torch.randn(k, n, generator=gen)
                               / np.sqrt(k)).to(dev))
    batched = quant.int8_matmul(x, w)
    for rows in (17, 100):
        torch.testing.assert_close(quant._launch(x[:rows], w, "tiled"),
                                   batched[:rows], atol=0, rtol=0)


@pytest.mark.parametrize("m", [1, 8, 16, 32, 512])
@pytest.mark.parametrize("k,n", MODEL_KN)
def test_int8_matmul_two_launches_give_the_same_bits(dev, m, k, n):
    """The skinny kernel's cluster reduction and the tiled kernel's sums
    run in a fixed order: no run-to-run variation."""
    gen = torch.Generator().manual_seed(m + k)
    x = torch.randn(m, k, generator=gen).to(dev)
    w = quant.quantize_weight((torch.randn(k, n, generator=gen)
                               / np.sqrt(k)).to(dev))
    assert torch.equal(quant.int8_matmul(x, w), quant.int8_matmul(x, w))


@pytest.mark.parametrize("rel_case", ["mixed", "one_live", "full"])
def test_paged_attention_kernel_at_the_engine_shape(dev, rel_case):
    """K9 at the engine's decode shape (8 slots, 12 heads x 64, block
    32, window 1024): the mixed rel case, one live position per slot and
    the full window, at 1e-5, twice with identical bits (the splits merge
    through the cluster in a fixed order)."""
    gen = torch.Generator().manual_seed(17)
    b, h, dh, bs, maxb = 8, 12, 64, 32, 32
    nb = b * maxb + maxb + 1
    q = torch.randn(b, h, dh, generator=gen).to(dev)
    kc = torch.randn(nb, bs, h, dh, generator=gen).to(dev)
    vc = torch.randn(nb, bs, h, dh, generator=gen).to(dev)
    bt = torch.randint(1, nb, (b, maxb), generator=gen).to(dev, torch.int32)
    rel = {"mixed": [0, 15, 31, 32, 500, 700, 1000, maxb * bs - 1],
           "one_live": [0] * b, "full": [maxb * bs - 1] * b}[rel_case]
    rel = torch.tensor(rel, dtype=torch.int32, device=dev)
    out = fk.paged_attention(q, kc, vc, bt, rel)
    again = fk.paged_attention(q, kc, vc, bt, rel)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, fk.paged_attention_reference(q, kc, vc, bt, rel),
        atol=1e-5, rtol=1e-5)
    assert torch.equal(out, again)


@pytest.mark.parametrize("b,t,h,d", [(2, 33, 3, 8), (1, 130, 2, 16),
                                     (2, 64, 2, 16), (1, 1000, 2, 64),
                                     (1, 70, 1, 64), (1, 1, 1, 64),
                                     (4, 512, 4, 32), (1, 97, 2, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_match_plain(dev, b, t, h, d, causal):
    """K1–K3 against their plain versions (o and lse at 1e-5, dQ/dK/dV at
    1e-4: the JAX flash tests' tolerances), ragged T included; two
    backward runs give identical bits (no atomics)."""
    gen = torch.Generator().manual_seed(b * t + d + causal)
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen).to(dev)
                   for _ in range(4))
    dlse = torch.randn(b, h, t, generator=gen).to(dev)
    counts = (fa.flash_attention.fwd_calls, fa.flash_attention.dq_calls,
              fa.flash_attention.dkv_calls)
    o, lse = fa.flash_fwd(q, k, v, causal)
    ro, rlse = fa.flash_fwd_reference(q, k, v, causal)
    torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    delta = ((do * o).sum(-1).transpose(1, 2) - dlse).contiguous()
    args = (q, k, v, do, lse, delta, causal)
    dq, (dk, dv) = fa.flash_dq(*args), fa.flash_dkv(*args)
    torch.testing.assert_close(dq, fa.flash_dq_reference(*args), rtol=1e-4,
                               atol=1e-4)
    rdk, rdv = fa.flash_dkv_reference(*args)
    torch.testing.assert_close(dk, rdk, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dv, rdv, rtol=1e-4, atol=1e-4)
    assert torch.equal(fa.flash_dq(*args), dq)
    assert all(torch.equal(x, y) for x, y in zip(fa.flash_dkv(*args),
                                                  (dk, dv)))
    assert (fa.flash_attention.fwd_calls, fa.flash_attention.dq_calls,
            fa.flash_attention.dkv_calls) == (counts[0] + 1, counts[1] + 2,
                                              counts[2] + 2)


def _flash_against_plain(dev, b, t, h, d, causal, gen, mul=1.0):
    """K1–K3 on one shape against their plain versions at the JAX flash
    tests' tolerances (o and lse 1e-5, dQ/dK/dV 1e-4); the backward gives
    identical bits twice."""
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen).to(dev)
                   for _ in range(4))
    q = q * mul
    dlse = torch.randn(b, h, t, generator=gen).to(dev)
    o, lse = fa.flash_fwd(q, k, v, causal)
    ro, rlse = fa.flash_fwd_reference(q, k, v, causal)
    torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    del ro, rlse
    delta = ((do * o).sum(-1).transpose(1, 2) - dlse).contiguous()
    args = (q, k, v, do, lse, delta, causal)
    dq = fa.flash_dq(*args)
    torch.testing.assert_close(dq, fa.flash_dq_reference(*args), rtol=1e-4,
                               atol=1e-4)
    dk, dv = fa.flash_dkv(*args)
    rdk, rdv = fa.flash_dkv_reference(*args)
    torch.testing.assert_close(dk, rdk, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dv, rdv, rtol=1e-4, atol=1e-4)
    assert torch.equal(fa.flash_dq(*args), dq)
    assert all(torch.equal(x, y) for x, y in zip(fa.flash_dkv(*args),
                                                  (dk, dv)))


@pytest.mark.parametrize("t", [1024, 50])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_tensor_core_split_stress(dev, t, causal):
    """K1–K3 (3xTF32 tensor cores) against their plain versions with q
    scaled by 4: scores of standard deviation near 16 and a peaked
    softmax, where a lost low-order TF32 half would show.  T = 50 is below
    one tile and a multiple of no tile edge.  Tolerances unchanged (o and
    lse 1e-5, dQ/dK/dV 1e-4); the backward gives identical bits twice."""
    gen = torch.Generator().manual_seed(t + causal)
    _flash_against_plain(dev, 2, t, 2, 64, causal, gen, mul=4.0)


@pytest.mark.parametrize("t", [4096, 8192])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_tensor_core_long_sequences(dev, t, causal):
    """K1–K3 at 4 and 8 times the training length: the long sums (P V, dQ,
    dV, dK over up to 8192 rows) add 4–8 times more rounded fresh
    fragments than at T = 1024, and must still meet the unchanged
    tolerances against the plain versions (whose T x T scores take about
    0.5 GB at 8192)."""
    gen = torch.Generator().manual_seed(t + causal)
    _flash_against_plain(dev, 1, t, 2, 64, causal, gen)


def test_flash_autograd_on_the_card_matches_dense(dev):
    """The autograd Function on CUDA tensors (K1, then K2 and K3 with a
    loss on both o and lse) against dense attention and the plain lse."""
    from autodist_tpu_torch.models.transformer import dense_attention

    gen = torch.Generator().manual_seed(3)
    q, k, v, w = (torch.randn(2, 50, 3, 16, generator=gen).to(dev)
                  for _ in range(4))
    wl = torch.randn(2, 3, 50, generator=gen).to(dev)
    grads = {}
    for name in ("flash", "plain"):
        ts = [x.clone().requires_grad_() for x in (q, k, v)]
        if name == "flash":
            o, lse = fa.flash_attention_with_lse(*ts, True)
        else:
            o = dense_attention(*ts, True)
            lse = torch.logsumexp(
                fa._scores(ts[0], ts[1], True), dim=-1)
        ((o * w).sum() + (lse * wl).sum()).backward()
        grads[name] = [x.grad for x in ts]
    for got, want in zip(grads["flash"], grads["plain"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_kernels_launch_on_a_card_that_is_not_current(dev):
    """Each wrapper launches on its tensors' card, whichever card is
    current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    d1 = torch.device("cuda", 1)
    gen = torch.Generator().manual_seed(9)
    q, k, v, do = (torch.randn(1, 70, 2, 16, generator=gen).to(d1)
                   for _ in range(4))
    with torch.cuda.device(0):
        o, lse = fa.flash_fwd(q, k, v, True)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        dq = fa.flash_dq(q, k, v, do, lse, delta, True)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, True)
        x = torch.randn(3, 100, generator=gen).to(d1)
        w = quant.quantize_weight(torch.randn(100, 77, generator=gen).to(d1))
        y = quant.int8_matmul(x, w)
        qp = torch.randn(2, 2, 16, generator=gen).to(d1)
        kc = torch.randn(5, 4, 2, 16, generator=gen).to(d1)
        bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=d1)
        rel = torch.tensor([5, 7], dtype=torch.int32, device=d1)
        pa = fk.paged_attention(qp, kc, kc, bt, rel)
    torch.cuda.synchronize(d1)
    ro, rlse = fa.flash_fwd_reference(q, k, v, True)
    torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    args = (q, k, v, do, lse, delta, True)
    torch.testing.assert_close(dq, fa.flash_dq_reference(*args), rtol=1e-4,
                               atol=1e-4)
    for got, want in zip((dk, dv), fa.flash_dkv_reference(*args)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y, quant.int8_matmul_reference(x, w),
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(
        pa, fk.paged_attention_reference(qp, kc, kc, bt, rel),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
def test_async_collectives_issue_on_nccl(dev, dtype):
    """``all_reduce_async`` and ``reduce_scatter_async`` on an NCCL group
    take the asynchronous branch (a work handle, waited on in ``wait()``)
    and give the synchronous functions' results; one rank, so the sums are
    the inputs (one-byte floats as their bits)."""
    import torch.distributed as dist

    from autodist_tpu_torch.kernel.synchronization import collectives as coll

    assert not dist.is_initialized()
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        group = dist.group.WORLD
        x = torch.randn(4096, generator=torch.Generator().manual_seed(5))
        x = x.to(dev, dtype)
        keep = x.clone()
        for issue, sync in ((coll.all_reduce_async, coll.all_reduce),
                            (coll.reduce_scatter_async,
                             coll.reduce_scatter)):
            pending = issue(x, group)
            assert pending._work is not None       # issued, not finished
            got = pending.wait()
            want = sync(x, group)
            assert got.dtype == dtype and got.device == x.device
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            assert torch.equal(got.view(torch.uint8), x.view(torch.uint8))
        assert torch.equal(x.view(torch.uint8), keep.view(torch.uint8))
    finally:
        dist.destroy_process_group()


def test_differentiable_collectives_on_nccl(dev):
    """The seq axis's differentiable collectives on a one-rank NCCL group:
    the ring shift (forward and the reverse shift in the backward), the
    tiled ``all_to_all`` and ``all_gather`` move device tensors and, with
    one rank, give back their inputs and pass the cotangent through."""
    import torch.distributed as dist

    from autodist_tpu_torch.kernel.synchronization import collectives as coll

    assert not dist.is_initialized()
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        group = dist.group.WORLD
        gen = torch.Generator().manual_seed(3)
        x = torch.randn(2, 8, 4, 32, generator=gen).to(dev)
        g = torch.randn(2, 8, 4, 32, generator=gen).to(dev)
        for fn in (lambda t: coll.ppermute(t, group),
                   lambda t: coll.ppermute(t, group, step=-1),
                   lambda t: coll.all_to_all_tiled(t, group, 2, 1),
                   lambda t: coll.all_gather_tiled(t, group, 1)):
            leaf = x.clone().requires_grad_(True)
            out = fn(leaf)
            assert out.device == x.device and torch.equal(out, x)
            out.backward(g)
            assert torch.equal(leaf.grad, g)
    finally:
        dist.destroy_process_group()


def test_model_axis_gather_and_slice_on_nccl(dev):
    """The model axis's gather and slice on a one-rank NCCL group move
    device tensors: ``gather_shards`` and ``shard_of`` give back their
    input, the differentiable ``gather_replicated`` / ``slice_replicated``
    pass the cotangent through."""
    import torch.distributed as dist

    from autodist_tpu_torch.kernel.synchronization import collectives as coll

    assert not dist.is_initialized()
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        group = dist.group.WORLD
        gen = torch.Generator().manual_seed(5)
        x = torch.randn(2, 8, 4, 32, generator=gen).to(dev)
        g = torch.randn(2, 8, 4, 32, generator=gen).to(dev)
        for axis in (0, 2):
            out = coll.gather_shards(x, group, axis)
            assert out.device == x.device and torch.equal(out, x)
            assert torch.equal(coll.shard_of(x, 1, 0, axis), x)
        for fn in (lambda t: coll.gather_replicated(t, group, 2),
                   lambda t: coll.slice_replicated(t, group, 2)):
            leaf = x.clone().requires_grad_(True)
            out = fn(leaf)
            assert out.device == x.device and torch.equal(out, x)
            out.backward(g)
            assert torch.equal(leaf.grad, g)
    finally:
        dist.destroy_process_group()


def test_flash_over_a_one_rank_nccl_model_group(dev):
    """``make_flash_attention(mesh)`` through its sharded branch on a
    one-rank NCCL model group (a mesh of model size 2 whose group holds
    this rank alone: the cut keeps every head, the gather is NCCL's):
    output and dq/dk/dv equal ``flash_attention``'s bit for bit; inside
    ``manual_axes`` it is ``flash_attention`` itself."""
    import types

    import torch.distributed as dist

    from autodist_tpu_torch.mesh import manual_axes

    assert not dist.is_initialized()
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        mesh = types.SimpleNamespace(model_size=2,
                                     model_group=dist.group.WORLD)
        wrapped = fa.make_flash_attention(mesh)
        gen = torch.Generator().manual_seed(9)
        q, k, v, do = (torch.randn(2, 128, 4, 64, generator=gen).to(dev)
                       for _ in range(4))
        outs = []
        for fn in (wrapped, fa.flash_attention):
            qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
            o = fn(*qkv, True)
            o.backward(do)
            outs.append([o.detach()] + [x.grad for x in qkv])
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        with manual_axes():
            assert torch.equal(wrapped(q, k, v, True), outs[1][0])
    finally:
        dist.destroy_process_group()


def test_flash_rejects_what_it_cannot_take(dev):
    x = torch.zeros(1, 8, 2, 8, device=dev)
    with pytest.raises(NotImplementedError, match="bf16"):
        fa.flash_attention(x.bfloat16(), x.bfloat16(), x.bfloat16())
    for d in (24, 128):
        y = torch.zeros(1, 8, 2, d, device=dev)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention(y, y, y)
    z = torch.zeros(64 * 8 + 1, device=dev)[1:].view(1, 8, 8, 8)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(z, z, z)


@pytest.mark.parametrize("n", [589_824, 1_000_003])
def test_detect_stats_kernel_matches_plain(dev, n):
    """K4: the count exactly, the sum of squares against an f64 sum, NaN
    and +-Inf counted once and poisoning the sum, the same bits twice."""
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(n, generator=gen).to(dev)
    before = fk.fused_detect_stats.calls
    nf, sq = fk.fused_detect_stats(x)
    again = fk.fused_detect_stats(x)
    torch.cuda.synchronize()
    assert fk.fused_detect_stats.calls == before + 2
    assert float(nf) == 0.0
    np.testing.assert_allclose(float(sq), float((x.double() ** 2).sum()),
                               rtol=1e-6)
    assert torch.equal(again[1], sq)
    for bad in (float("nan"), float("inf"), -float("inf")):
        y = x.clone()
        y[n // 3] = bad
        bnf, bsq = fk.fused_detect_stats(y)
        assert float(bnf) == 1.0 and not np.isfinite(float(bsq))
    rnf, rsq = fk.fused_detect_stats_reference(x[1:])
    knf, ksq = fk.fused_detect_stats(x[1:])     # not 16-byte aligned
    assert float(knf) == float(rnf) == 0.0
    np.testing.assert_allclose(float(ksq), float(rsq), rtol=1e-6)


@pytest.mark.parametrize("n", [589_824, 1_000_003])
def test_adam_kernel_matches_plain(dev, n):
    gen = torch.Generator().manual_seed(n + 1)
    p, g, mu = (torch.randn(n, generator=gen).to(dev) for _ in range(3))
    nu = torch.rand(n, generator=gen).to(dev)
    spec = fk.AdamSpec(lr=1e-3)
    rp, rmu, rnu = p, mu, nu
    before = fk.fused_adam_update.calls
    for step, mult in enumerate((1.0, 0.25, 1.0)):
        count = torch.tensor(step, dtype=torch.int32, device=dev)
        mult = torch.tensor(mult, device=dev)
        scalars = fk.adam_scalars(count, spec, mult)
        p, mu, nu = fk.fused_adam_update(p, g, mu, nu, scalars, spec)
        rp, rmu, rnu = fk.fused_adam_update_reference(rp, g, rmu, rnu,
                                                      scalars, spec)
    torch.cuda.synchronize()
    assert fk.fused_adam_update.calls == before + 3
    for got, want in ((p, rp), (mu, rmu), (nu, rnu)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def _same_payload(a, b) -> bool:
    """Wire payloads bit-equal, fp8 NaN compared as NaN."""
    if a.dtype == torch.int8:
        return torch.equal(a, b)
    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    return torch.equal(na, nb) and torch.equal(a.view(torch.uint8)[~na],
                                               b.view(torch.uint8)[~nb])


@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("n", [147_456, 1_000_003, 300])
def test_quant_hop_kernels_match_plain(dev, wire, n):
    """K6–K8 against their plain versions: payload bit-equal (NaN as NaN),
    scales equal, error and the dequant-add at atol 1e-6, saturation
    counts equal (at least 3 on the poisoned input), the same bits twice,
    and a chunk that is not 16-byte aligned."""
    from autodist_tpu_torch.kernel.synchronization import quant_ring as qr

    fmt = qr.WIRE_INT8 if wire == "int8" else qr.WIRE_FP8_E4M3
    gen = torch.Generator().manual_seed(n)
    x = (torch.randn(n + 1, generator=gen) * 3).to(dev)
    chunk = torch.randn(n + 1, generator=gen).to(dev)
    poisoned = x.clone()
    poisoned[[5, n // 2, n - 1]] = torch.tensor(
        [float("inf"), float("nan"), -float("inf")], device=dev)
    for src, c, poison in ((x[:n], chunk[:n], False),
                           (poisoned[:n], chunk[:n], True),
                           (x[1:], chunk[1:], False)):
        before = (fk.fused_quantize.calls, fk.fused_hop_accumulate.calls,
                  fk.fused_dequant_add.calls)
        got = fk.fused_quantize(src, fmt)
        again = fk.fused_quantize(src, fmt)
        q_in, s_in = fk.fused_quantize(src / 3, fmt)[:2]
        hop = fk.fused_hop_accumulate(q_in, s_in, c, fmt)
        out = fk.fused_dequant_add(q_in, s_in, c, fmt)
        torch.cuda.synchronize()
        assert (fk.fused_quantize.calls - before[0],
                fk.fused_hop_accumulate.calls - before[1],
                fk.fused_dequant_add.calls - before[2]) == (3, 1, 1)
        for kernel, want in (
                (got, fk.fused_quantize_reference(src, fmt)),
                (hop, fk.fused_hop_accumulate_reference(q_in, s_in, c,
                                                        fmt))):
            (q, s, err, sat), (rq, rs, rerr, rsat) = kernel, want
            assert _same_payload(q, rq)
            assert torch.equal(s, rs)
            torch.testing.assert_close(err, rerr, atol=1e-6, rtol=0,
                                       equal_nan=True)
            assert float(sat) == float(rsat)
        torch.testing.assert_close(
            out, fk.fused_dequant_add_reference(q_in, s_in, c, fmt),
            atol=1e-6, rtol=0, equal_nan=True)
        assert _same_payload(again[0], got[0])
        assert torch.equal(again[1], got[1])
        assert torch.equal(again[2].nan_to_num(), got[2].nan_to_num())
        assert float(again[3]) == float(got[3])
        if poison:
            assert float(got[3]) >= 3
    with pytest.raises(ValueError, match="q_in"):
        fk.fused_dequant_add(q_in[:-1], s_in, c, fmt)


def test_zero1_guard_session_launches_k4_and_k5(dev):
    """Three steps of ``Zero1`` with ``fusable_adam`` and a clip on the card:
    K4 twice per bucket and K5 once per bucket per step, finite falling
    losses, nothing skipped."""
    import os

    from autodist_tpu_torch.autodist import (
        AutoDist, _reset_default_autodist_for_testing)
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.strategy import Zero1

    os.environ["AUTODIST_IS_TESTING"] = "True"
    _reset_default_autodist_for_testing()
    spec = transformer_lm(vocab_size=97, num_layers=2, num_heads=2,
                          head_dim=8, d_ff=32, max_len=16)
    ad = AutoDist(strategy_builder=Zero1(bucket_bytes=1 << 12))
    with ad.scope():
        ad.capture(params=spec.init(0), optimizer=fk.fusable_adam(1e-2),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   numerics={"clip_norm": 1.0})
    sess = ad.create_distributed_session()
    n_buckets = len(sess.zero1_buckets)
    assert n_buckets > 1
    batch = spec.sample_batch(8, seed=1)
    losses = []
    for _ in range(3):
        k4, k5 = fk.fused_detect_stats.calls, fk.fused_adam_update.calls
        out = sess.run(batch)
        assert fk.fused_detect_stats.calls - k4 == 2 * n_buckets
        assert fk.fused_adam_update.calls - k5 == n_buckets
        assert bool(out["grad_health"].all_finite)
        assert int(out["grad_health"].skipped_steps) == 0
        losses.append(float(out["loss"]))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("name", ["PSLoadBalancing", "Parallax"])
def test_ps_family_session_on_the_card_matches_the_cpu(dev, name):
    """Three steps of the PS family's bucketed step (the facade's default
    ``PSLoadBalancing``, and ``Parallax``'s mix of all-reduce and
    reduce-scatter buckets) with ``fusable_adam`` and a clip, on the card
    and on the CPU (K4 and K5's plain versions), on the linear loss of
    ``tests/torch_dp_worker.py`` whose gradients are the batch's mean row:
    K5 once per reduce-scatter bucket and K4 twice per bucket each step on
    the card; parameters and moments at K5's atol 1e-6, losses at rtol
    1e-6."""
    import os
    import sys
    from pathlib import Path

    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.autodist import (
        AutoDist, _reset_default_autodist_for_testing)
    from autodist_tpu_torch.graph_item import flatten
    from autodist_tpu_torch.models.transformer_lm import transformer_lm

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_dp_worker as worker

    os.environ["AUTODIST_IS_TESTING"] = "True"
    spec = transformer_lm(**worker.CFG)
    runs = {}
    for device in ("cuda", "cpu"):
        _reset_default_autodist_for_testing()
        params = spec.init(0, device="cpu")
        ad = AutoDist(strategy_builder=getattr(strategy, name)(),
                      device=device)
        with ad.scope():
            ad.capture(params=params, optimizer=fk.fusable_adam(1e-2),
                       loss_fn=worker.linear_loss,
                       sparse_vars=spec.sparse_vars,
                       numerics={"clip_norm": 1e-2})
        sess = ad.create_distributed_session()
        buckets, rs = sess._step.buckets, sess.zero1_buckets
        assert len(rs) == 1 and (len(buckets) > 1) == (name == "Parallax")
        batch = worker.linear_batch(params)
        losses = []
        for _ in range(3):
            k4, k5 = fk.fused_detect_stats.calls, fk.fused_adam_update.calls
            out = sess.run(batch)
            launched = (fk.fused_detect_stats.calls - k4,
                        fk.fused_adam_update.calls - k5)
            assert launched == ((2 * len(buckets), len(rs))
                                if device == "cuda" else (0, 0))
            assert bool(out["grad_health"].all_finite)
            losses.append(float(out["loss"]))
        _, opt = sess.export_state()
        runs[device] = (losses, dict(flatten(sess.params)),
                        {k: v.cpu() for k, v in flatten(opt)})
    (gl, gp, go), (wl, wp, wo) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(gl, wl, rtol=1e-6)
    assert gp.keys() == wp.keys() and go.keys() == wo.keys()
    for n in wp:
        np.testing.assert_allclose(gp[n], wp[n], rtol=0, atol=1e-6,
                                   err_msg=n)
    for n in wo:
        torch.testing.assert_close(go[n], wo[n], rtol=0, atol=1e-6,
                                   msg=n)


def _worker():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_dp_worker as worker
    return worker


def _baseline_steps(worker, name, device, builder, opt, numerics, steps=2):
    """``steps`` facade steps of the tiny ``name`` on ``device`` from the
    port's init (seed 0): losses, final parameters and the K1–K5 launches
    of each step."""
    import os

    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.autodist import (
        AutoDist, _reset_default_autodist_for_testing)
    from autodist_tpu_torch.graph_item import flatten

    os.environ["AUTODIST_IS_TESTING"] = "True"
    _reset_default_autodist_for_testing()
    spec = worker.model_spec(name)
    ad = AutoDist(strategy_builder=getattr(strategy, builder)(),
                  device=device)
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"), optimizer=opt,
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   numerics=numerics)
    sess = ad.create_distributed_session()
    batch = spec.sample_batch(worker.MODEL_BATCH, seed=1)
    losses, launches = [], []

    def counts():
        return (fa.flash_attention.fwd_calls, fa.flash_attention.dq_calls,
                fa.flash_attention.dkv_calls, fk.fused_detect_stats.calls,
                fk.fused_adam_update.calls)
    for _ in range(steps):
        before = counts()
        losses.append(float(sess.run(batch)["loss"]))
        launches.append(tuple(a - b for a, b in zip(counts(), before)))
    return losses, dict(flatten(sess.params)), launches, sess


@pytest.mark.parametrize("name", ["resnet", "vgg", "bert", "lm1b"])
def test_baseline_model_step_on_the_card_matches_the_cpu(dev, name):
    """Each tiny BASELINE model (``tests/torch_dp_worker.py``'s
    ``MODEL_RUNS``) under its builder and optimizer: 2 steps on the card
    against the same steps on the CPU (the plain versions), losses at rtol
    1e-5 and parameters at atol 1e-4 (the gloo tests' tolerances).  BERT
    attends through K1–K3 non-causal on the card (one launch of each per
    layer per step, one K1 per layer in ``evaluate``); VGG's guard runs K4
    twice per bucket."""
    import warnings

    from autodist_tpu_torch import optim

    worker = _worker()
    builder, opt, kw, numerics = worker.MODEL_RUNS[name]
    runs = {}
    for device in ("cuda", "cpu"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # sgd's unfused shard update
            runs[device] = _baseline_steps(
                worker, name, device, builder, getattr(optim, opt)(**kw),
                numerics)
    (gl, gp, launches, sess), (wl, wp, cpu_launches, _) = \
        runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    assert gp.keys() == wp.keys()
    for n in wp:
        np.testing.assert_allclose(gp[n], wp[n], rtol=0, atol=1e-4,
                                   err_msg=n)
    layers = worker.MODEL_CFGS["bert"]["num_layers"]
    k4 = 2 * len(sess._step.buckets) if numerics else 0
    want = (layers,) * 3 + (0, 0) if name == "bert" else (0, 0, 0, k4, 0)
    assert launches == [want, want]
    assert cpu_launches == [(0,) * 5] * 2
    if name == "bert":
        before = fa.flash_attention.fwd_calls
        sess.evaluate(worker.model_spec(name).sample_batch(
            worker.MODEL_BATCH, seed=1))
        assert fa.flash_attention.fwd_calls - before == layers


def test_lm1b_parallax_fusable_adam_launches_k5_on_the_card(dev):
    """Tiny lm1b under ``Parallax`` with ``fusable_adam`` and the clip: its
    two tables in reduce-scatter buckets take K5 (one launch per bucket per
    step), K4 twice per bucket; losses and parameters against the CPU at
    rtol 1e-5 / atol 1e-4."""
    worker = _worker()
    runs = {device: _baseline_steps(worker, "lm1b", device, "Parallax",
                                    fk.fusable_adam(1e-2), {"clip_norm": 1.0},
                                    steps=3)
            for device in ("cuda", "cpu")}
    (gl, gp, launches, sess), (wl, wp, _, _) = runs["cuda"], runs["cpu"]
    rs = len(sess.zero1_buckets)
    assert rs >= 1 and sorted(n for b in sess.zero1_buckets
                              for n in b.names) == ["embedding",
                                                    "softmax_embedding"]
    assert launches == [(0, 0, 0, 2 * len(sess._step.buckets), rs)] * 3
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    for n in wp:
        np.testing.assert_allclose(gp[n], wp[n], rtol=0, atol=1e-4,
                                   err_msg=n)


def _tiny_lm_session(dtype=torch.float32, builder=None, optimizer=None,
                     guard=True):
    """A tiny ``transformer_lm`` session on the card (flash K1–K3 by
    default) and its batch."""
    import os

    from autodist_tpu_torch.autodist import (
        AutoDist, _reset_default_autodist_for_testing)
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.strategy import PSLoadBalancing

    os.environ["AUTODIST_IS_TESTING"] = "True"
    _reset_default_autodist_for_testing()
    spec = transformer_lm(vocab_size=97, num_layers=2, num_heads=2,
                          head_dim=16, d_ff=32, max_len=16, dtype=dtype)
    ad = AutoDist(strategy_builder=builder or PSLoadBalancing())
    with ad.scope():
        ad.capture(params=spec.init(0), optimizer=optimizer
                   or fk.fusable_adam(1e-2), loss_fn=spec.loss_fn,
                   sparse_vars=spec.sparse_vars,
                   numerics={"clip_norm": 1.0} if guard else None)
    return ad.create_distributed_session(), spec.sample_batch(8, seed=1)


def test_fit_resume_on_the_card_is_bit_identical(dev, tmp_path):
    """``fit`` with a checkpoint after epoch 1 and a fresh session's
    ``fit(resume=True)`` to 3 epochs ends on the uninterrupted run's epoch
    losses and parameters to the bit (the facade's default with K1–K5)."""
    from autodist_tpu_torch.graph_item import flatten

    sess, batch = _tiny_lm_session()
    data = [batch, dict(batch, tokens=batch["tokens"][::-1].copy())]
    want = sess.fit(data, epochs=3).history["epoch_loss"]
    want_p = dict(flatten(sess.params))
    sess, _ = _tiny_lm_session()
    sess.fit(data, epochs=1, steps_per_epoch=2, checkpoint_dir=str(tmp_path))
    calls = fa.flash_attention.fwd_calls
    sess, _ = _tiny_lm_session()
    hist = sess.fit(data, epochs=3, steps_per_epoch=2,
                    checkpoint_dir=str(tmp_path))
    assert fa.flash_attention.fwd_calls - calls == 2 * 4
    assert hist.history["epoch_loss"] == want[1:]
    for name, x in flatten(sess.params):
        np.testing.assert_array_equal(x, want_p[name], err_msg=name)


def test_bf16_lm_trains_a_step_through_the_f32_flash_kernels(dev):
    """A bf16 ``transformer_lm`` (bf16 embedding tables, f32 decoder, as
    in the JAX package) trains on the card: attention gets f32 q/k/v, so
    K1–K3 launch once per layer per step, and the loss is finite."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.strategy import AllReduce

    sess, batch = _tiny_lm_session(torch.bfloat16, AllReduce(),
                                   optim.adam(1e-2), guard=False)
    assert sess.device_params["embed"].dtype == torch.bfloat16
    assert sess.device_params["decoder"]["ln_final"]["scale"].dtype \
        == torch.float32
    before = (fa.flash_attention.fwd_calls, fa.flash_attention.dq_calls,
              fa.flash_attention.dkv_calls)
    loss = float(sess.run(batch)["loss"])
    after = (fa.flash_attention.fwd_calls, fa.flash_attention.dq_calls,
             fa.flash_attention.dkv_calls)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2]
    assert np.isfinite(loss)
    assert sess.device_params["embed"].dtype == torch.bfloat16


def test_moe_lm_step_on_the_card_launches_k1_k3_and_matches_the_cpu(dev):
    """One step of the MoE LM (2 layers, 4 experts, the JAX test's other
    widths and seq 64) through the facade's default ``PSLoadBalancing``
    with ``fusable_adam`` and the clip, its attention through
    ``flash_attention``: on the card K1–K3 once per layer each, K4/K5 as
    the schedule IR predicts; the loss, the global norm and the updated
    parameters at rtol 1e-4 of the CPU run's (K1–K5's plain versions)."""
    import os

    from autodist_tpu_torch.autodist import (
        AutoDist, _reset_default_autodist_for_testing)
    from autodist_tpu_torch.graph_item import flatten
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
    from autodist_tpu_torch.models.moe_lm import moe_transformer_lm
    from autodist_tpu_torch.strategy import PSLoadBalancing

    os.environ["AUTODIST_IS_TESTING"] = "True"
    layers = 2
    spec = moe_transformer_lm(
        None, vocab_size=64, num_layers=layers, num_heads=2, head_dim=16,
        d_ff=32, num_experts=4, max_len=64, attn_fn=fa.flash_attention)
    batch = spec.sample_batch(4)
    runs = {}
    for device in ("cuda", "cpu"):
        _reset_default_autodist_for_testing()
        ad = AutoDist(strategy_builder=PSLoadBalancing(), device=device)
        with ad.scope():
            ad.capture(params=spec.init(0, device="cpu"),
                       optimizer=fk.fusable_adam(1e-3),
                       loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                       expert_vars=spec.expert_vars,
                       numerics={"clip_norm": 1.0})
        sess = ad.create_distributed_session()
        fa.reset_counts()
        k4, k5 = fk.fused_detect_stats.calls, fk.fused_adam_update.calls
        out = sess.run(batch)
        launched = (fa.flash_attention.fwd_calls, fa.flash_attention.dq_calls,
                    fa.flash_attention.dkv_calls,
                    fk.fused_detect_stats.calls - k4,
                    fk.fused_adam_update.calls - k5)
        ir = sess.schedule_ir
        want = (layers, layers, layers,
                2 * sum(leg.kind == sir.LEG_FUSED_DETECT for leg in ir.legs),
                sum(leg.kind == sir.LEG_FUSED_UPDATE for leg in ir.legs))
        assert launched == (want if device == "cuda" else (0,) * 5)
        assert bool(out["grad_health"].all_finite)
        runs[device] = (float(out["loss"]),
                        float(out["grad_health"].global_norm),
                        dict(flatten(sess.params)))
    (gl, gn, gp), (wl, wn, wp) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose([gl, gn], [wl, wn], rtol=1e-4)
    for n in wp:
        np.testing.assert_allclose(gp[n], wp[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)
