"""The arithmetic and layouts of the redesigned serving kernels, modelled in
numpy on the CPU: K10 (``int8_matmul_f32`` in
``autodist_tpu_torch/csrc/int8_matmul.cu``) and the shared-memory layout of
K9 (``paged_attention_f32`` in ``csrc/paged_attention.cu``).

K10 runs on the tensor cores in 2xTF32: an int8 weight is exact in TF32, so
only x is split (``hi = rna(x)``, ``lo = rna(x - hi)``) and each 8-wide
k-step is two mmas, lo then hi, of the transposed product ``q^T x^T``.
The model uses the flash kernels' model of the hardware
(``tests/test_torch_flash_tc.py``: products of TF32 values exact, the
accumulator rounded toward zero once per mma, a fresh fragment every 4
k-steps added to the running sum with round to nearest):

* the tiled (prefill) kernel: K cut into a cluster's contiguous ranges
  of whole 64-row units, each range's k-steps in order, then the ranks'
  partials added in order;
* the skinny (decode) kernel: K cut into ``cluster x 8`` contiguous warp
  slices of k-steps, each slice's sum as above, then the warps' partials
  added in order and the cluster ranks' in order.

Both are held against the JAX package's ``int8_matmul`` (its Pallas kernel
in interpret mode, as ``tests/test_quant.py`` runs it) at the kernel's
tolerance, rtol 1e-5 / atol 1e-4, at the model's scales (unit x,
lecun-normal weights) and at x x 4; the same model in plain TF32 misses
it.  Further: the int8 -> f32 conversion by byte permutation, for every
byte; the lane-level fragment maps of the transposed product and its
epilogue; the padded shared-memory strides that make the kernels' reads
conflict-free; and the wrappers' launch choices.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from autodist_tpu.ops.quant import Quantized as JQuantized
from autodist_tpu.ops.quant import int8_matmul as jint8_matmul
from autodist_tpu.ops.quant import quantize_weight as jquantize_weight
from autodist_tpu_torch.ops import fused_kernels as fk
from autodist_tpu_torch.ops import quant
from test_torch_flash_tc import _conflict_free, mma_f32, mma_lanes, split

pytestmark = pytest.mark.torch_port

GROUP = 4           # kGroup: k-steps per fresh fragment
SKINNY_WARPS = 8    # warps (K slices) per skinny block
SPLIT_UNIT = 64     # the tiled kernel splits K at multiples of 64 rows


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _product(x, q, terms):
    """``(x [M, K] @ q [K, N])`` as the kernels form it, transposed:
    ``q^T`` is the mma's A operand (exact in TF32), x the B operand."""
    return mma_f32(q.T.astype(np.float32), x.T.astype(np.float32),
                   terms=terms, group=GROUP, truncate=True).T


def tiled_model(x, q, scale, split: int = 1, terms: int = 2):
    """The tiled kernel with K split over a cluster of ``split`` blocks:
    rank r sums its k-steps in order over a range of ``per`` whole units
    of 64 k rows, then the ranks' partials are added in order, then the
    scale."""
    k = x.shape[1]
    per = -(-(-(-k // SPLIT_UNIT)) // split)
    total = np.zeros((x.shape[0], q.shape[1]), np.float32)
    for rank in range(split):
        k0 = min(k, rank * per * SPLIT_UNIT)
        k1 = min(k, k0 + per * SPLIT_UNIT)
        if k1 > k0:
            total = (total + _product(x[:, k0:k1], q[k0:k1],
                                      terms)).astype(np.float32)
    return (total * scale).astype(np.float32)


def skinny_model(x, q, scale, cluster: int, terms: int = 2):
    """The skinny kernel with a cluster of ``cluster`` blocks: warp slice
    s (rank s // 8, warp s % 8) takes k-steps [s * per, (s + 1) * per);
    the block adds its warps' partials in order, then the ranks' partials
    are added in order, then the scale."""
    m, k = x.shape
    ksteps = -(-k // 8)
    slices = cluster * SKINNY_WARPS
    per = -(-ksteps // slices)
    total = np.zeros((m, q.shape[1]), np.float32)
    for rank in range(cluster):
        block = np.zeros_like(total)
        for w in range(SKINNY_WARPS):
            k0 = min(k, 8 * (rank * SKINNY_WARPS + w) * per)
            k1 = min(k, k0 + 8 * per)
            if k1 > k0:
                block = (block + _product(x[:, k0:k1], q[k0:k1],
                                          terms)).astype(np.float32)
        total = (total + block).astype(np.float32)
    return (total * scale).astype(np.float32)


def _inputs(seed, m, k, n, mul=1.0):
    """Unit x (times ``mul``) and a lecun-normal weight quantized by the
    JAX package: ``(x, q, scale)`` as numpy."""
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((m, k)) * mul).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    qw = jquantize_weight(jnp.asarray(w))
    return x, np.asarray(qw.q), np.asarray(qw.scale)


def _jax(x, q, scale):
    return np.asarray(jint8_matmul(jnp.asarray(x), JQuantized(
        q=jnp.asarray(q), scale=jnp.asarray(scale)), interpret=True))


CASES = [(24, 768, 40, 1.0), (24, 768, 40, 4.0), (5, 3072, 24, 1.0),
         (5, 3072, 24, 4.0), (17, 100, 77, 1.0)]


# ---------------------------------------------------------------------------
# the arithmetic against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n,mul", CASES)
@pytest.mark.parametrize("split", [1, 2, 6])
def test_tiled_model_meets_the_kernel_tolerance_against_jax(m, k, n, mul,
                                                            split):
    x, q, scale = _inputs(m + k + n, m, k, n, mul)
    np.testing.assert_allclose(tiled_model(x, q, scale, split),
                               _jax(x, q, scale), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,k,n,mul", CASES)
@pytest.mark.parametrize("cluster", [1, 3, 8])
def test_skinny_model_meets_the_kernel_tolerance_against_jax(m, k, n, mul,
                                                             cluster):
    x, q, scale = _inputs(m + k + n, m, k, n, mul)
    np.testing.assert_allclose(skinny_model(x, q, scale, cluster),
                               _jax(x, q, scale), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mul", [1.0, 4.0])
def test_plain_tf32_model_misses_the_tolerance(mul):
    """One TF32 term (x rounded to 10 mantissa bits) is off by ~2e-4 of
    the output: the lo half of x is what meets the kernel's tolerance."""
    x, q, scale = _inputs(7, 24, 768, 40, mul)
    want = _jax(x, q, scale)
    assert not np.allclose(tiled_model(x, q, scale, 2, terms=1), want,
                           rtol=1e-5, atol=1e-4)
    assert not np.allclose(skinny_model(x, q, scale, 8, terms=1), want,
                           rtol=1e-5, atol=1e-4)


def test_split_of_x_leaves_an_f32_sized_residual():
    """``x - hi - lo`` is within 2^-21 of |x| (hi and lo keep 11 bits
    each), where one TF32 rounding leaves up to 2^-11."""
    x = np.random.RandomState(3).standard_normal(100_000).astype(np.float32)
    hi, lo = split(x)
    res = np.abs(x.astype(np.float64) - hi - lo) / np.abs(x)
    assert res.max() <= 2.0 ** -21
    assert (np.abs(x.astype(np.float64) - hi) / np.abs(x)).max() > 2.0 ** -13


def test_rows_do_not_depend_on_how_many_ride_along():
    """A row's result is a function of that row and K in both models
    (the kernels' M-independence): 3 rows of a batch equal them alone."""
    x, q, scale = _inputs(11, 16, 256, 48)
    np.testing.assert_array_equal(tiled_model(x[:3], q, scale, 2),
                                  tiled_model(x, q, scale, 2)[:3])
    np.testing.assert_array_equal(skinny_model(x[:1], q, scale, 4),
                                  skinny_model(x, q, scale, 4)[:1])


# ---------------------------------------------------------------------------
# int8 -> f32 by byte permutation
# ---------------------------------------------------------------------------
def byte_perm(x, y, s):
    """CUDA's ``__byte_perm(x, y, s)`` on uint32 arrays: result byte n is
    byte ``(s >> 4n) & 7`` of the 8 bytes ``y:x``."""
    src = (np.asarray(y, np.uint64) << np.uint64(32)) \
        | np.asarray(x, np.uint64)
    out = np.zeros(np.shape(x), np.uint64)
    for n in range(4):
        sel = np.uint64((s >> (4 * n)) & 7)
        out |= ((src >> (np.uint64(8) * sel)) & np.uint64(0xFF)) \
            << np.uint64(8 * n)
    return out.astype(np.uint32)


def i8x4_to_f32(words):
    """The kernels' ``i8x4_to_f32``: the four bytes of each word as floats,
    low byte first, without an int-to-float conversion."""
    u = np.asarray(words, np.uint32) ^ np.uint32(0x80808080)
    return np.stack([byte_perm(u, 0x4B000000, 0x7440 + i).view(np.float32)
                     - np.float32(8388736.0) for i in range(4)], axis=-1)


def test_byte_permutation_converts_every_int8_exactly():
    q = np.arange(-128, 128, dtype=np.int8)
    words = q.view(np.uint8).reshape(-1, 4).copy().view(np.uint32)[:, 0]
    got = i8x4_to_f32(words).reshape(-1)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, q.astype(np.float32))
    # and the values are exact in TF32: the low 13 bits are zero
    assert not np.any(got.view(np.uint32) & np.uint32(0x1FFF))


# ---------------------------------------------------------------------------
# fragment maps of the transposed product
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mt", [2, 4, 8])
def test_fragments_and_epilogue_give_x_times_q(mt):
    """One k-step, lane by lane: lane (g, t) converts 2 MT bytes of q rows
    2t and 2t + 1 from column 2 MT g, m-tile i takes bytes 2i (A row g) and
    2i + 1 (A row g + 8), B is x[g][2t], x[g][2t + 1]; the epilogue puts
    C register 2h + e of m-tile i at row 2t + e, column 2 MT g + 2i + h.
    The result is x @ q for 8 rows of x and 16 MT columns."""
    rng = np.random.RandomState(mt)
    q = rng.randint(-128, 128, (8, 16 * mt)).astype(np.float64)
    x = rng.randint(-50, 50, (8, 8)).astype(np.float64)
    lanes = [divmod(lane, 4) for lane in range(32)]
    b_regs = [[x[g, 2 * t], x[g, 2 * t + 1]] for g, t in lanes]
    zeros = [[0.0] * 4 for _ in range(32)]
    out = np.full((8, 16 * mt), np.nan)
    for i in range(mt):
        a_regs = []
        for g, t in lanes:
            f0 = q[2 * t, 2 * mt * g:2 * mt * (g + 1)]
            f1 = q[2 * t + 1, 2 * mt * g:2 * mt * (g + 1)]
            a_regs.append([f0[2 * i], f0[2 * i + 1], f1[2 * i],
                           f1[2 * i + 1]])
        c = mma_lanes(a_regs, b_regs, zeros)
        for (g, t), regs in zip(lanes, c):
            for h in (0, 1):
                for e in (0, 1):
                    out[2 * t + e, 2 * mt * g + 2 * i + h] = regs[2 * h + e]
    np.testing.assert_array_equal(out, x @ q)


# ---------------------------------------------------------------------------
# shared-memory banks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mt,bk", [(2, 64), (4, 64), (4, 32)])
def test_k10_tiled_reads_are_conflict_free(mt, bk):
    """The tiled kernel's fragment reads hit 32 distinct banks per phase
    (its variants: 2 or 4 m-tiles per warp, tiles of 64 or 32 k rows):
    q (int8, row stride 32 MT + 16 bytes) as 2 MT bytes of rows 2t and
    2t + 1 from byte column wc + 2 MT g, and split x (row stride 2 BK + 16
    floats, [k][hi, lo] interleaved) as 16 bytes of row 8j + g from
    16 s + 4t.  Unpadded strides would conflict."""
    ldq = 32 * mt + 16
    ld_split = 2 * bk + 16
    width = 2 * mt                       # bytes per lane of a q row
    for s in range(bk // 8):
        for wc in (0, 16 * mt):
            for row in (0, 1):
                assert _conflict_free(
                    lambda g, t: ((8 * s + 2 * t + row) * ldq + wc
                                  + width * g) // 4, width)
        for j in range(4):
            assert _conflict_free(
                lambda g, t: (8 * j + g) * ld_split + 16 * s + 4 * t, 16)
    assert not _conflict_free(lambda g, t: (2 * t * 32 * mt + width * g)
                              // 4, width)
    assert not _conflict_free(lambda g, t: g * 2 * bk + 4 * t, 16)


@pytest.mark.parametrize("dh", [16, 40, 64, 128, 7, 33])
def test_k9_reads_are_conflict_free(dh):
    """K9's score reads: lane (position pp = g, quarter t) reads chunk
    t + 4i of K row pp as a float4; rows padded to a stride of 16 (mod 32)
    floats hit 32 banks per phase.  V rows are read by 32 lanes in a row
    (always conflict-free).  At Dh = 64 an unpadded row would conflict."""
    d4 = -(-dh // 4) * 4
    ldk = d4 + (16 - d4) % 32
    assert ldk % 32 == 16 and ldk >= d4
    for i in range(-(-d4 // 16)):
        assert _conflict_free(lambda g, t: g * ldk + 4 * t + 16 * i, 16)
    assert _conflict_free(lambda g, t: 3 * d4 + 4 * g + t, 4)
    if dh == 64:
        assert not _conflict_free(lambda g, t: g * d4 + 4 * t, 16)
    # the wrapper's shared-memory formula is the source's layout
    assert fk.paged_smem_bytes(dh) == 4 * 4 * 3 * 8 * (ldk + d4)


# ---------------------------------------------------------------------------
# launch choices
# ---------------------------------------------------------------------------
def test_skinny_cluster_depends_on_n_and_k_only():
    for n, k, want in ((768, 768, 8), (3072, 768, 3), (768, 3072, 8),
                       (32128, 768, 1), (130, 5, 1), (1002, 4099, 8)):
        assert quant.skinny_cluster(n, k, 132) == want


def test_tiled_split_depends_on_n_and_k_only():
    assert quant.tiled_split(768, 768) == 1
    assert quant.tiled_split(768, 3072) == 2
    assert quant.tiled_split(3072, 768) == 1
    assert quant.tiled_split(32128, 768) == 1
    assert quant.tiled_split(77, 100) == 1
    assert quant.tiled_split(1002, 4099) == 2


@pytest.mark.parametrize("m,n,k,want", [
    (512, 768, 768, 2),      # 6 x 16 = 96 blocks
    (512, 3072, 768, 2),     # 24 x 16 = 384
    (512, 768, 3072, 1),     # 24 x 16 x 2 = 768
    (512, 32128, 768, 3),    # 251 x 8 = 2008
    (2048, 768, 768, 2),     # 6 x 64 = 384
    (2048, 768, 3072, 3),    # 6 x 32 x 2 = 384
    (2048, 3072, 768, 3),    # 24 x 32 = 768
    (64, 768, 768, 1),       # 12 x 4 = 48
    (17, 77, 100, 1)])
def test_tiled_variant_follows_the_measured_choice(m, n, k, want):
    """The tile the H100 ran fastest (or within 7% of it) at the model's
    prefill shapes, by the rule: 384 blocks (about three per SM) from the
    largest tile down, else the middle tile at 96 blocks."""
    assert quant.tiled_variant(m, n, k) == want


def test_paged_splits_stay_inside_a_portable_cluster():
    assert fk.splits_for(8, 12, 1024, 132) == 4
    assert fk.splits_for(1, 1, 24, 132) == 1
    assert fk.splits_for(48, 12, 32, 132) == 1
    assert all(1 <= fk.splits_for(b, 12, 1024, 132) <= 8
               for b in range(1, 65))
