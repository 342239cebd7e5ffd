"""The arithmetic the tensor-core flash kernels (K1 ``flash_fwd_f32``, K2
``flash_dq_f32``, K3 ``flash_dkv_f32`` in
``autodist_tpu_torch/csrc/flash_attention.cu``) rely on, modelled in numpy
on the CPU.

This is a model of the hardware, not its exact rule: NVIDIA does not
document how the tensor cores round their f32 accumulation.  The model
takes the mma's products of TF32 values as exact and rounds the
accumulator once per mma, either to nearest or toward zero (truncation,
what the card showed: K1 and K3 with one accumulator per output passed
the round-to-nearest model and failed on the card).  A design that meets the tolerances under
the truncating model with room to spare is what goes to the card; the
card tests decide.

* ``cvt.rna.tf32.f32``: round to nearest, ties away from zero, to 10
  mantissa bits (a bit trick here, held against a float64 definition);
* the 3xTF32 product: each f32 operand split into TF32 ``big = rna(x)``
  and ``small = rna(x - big)``; ``small·big + big·small + big·big``
  accumulated in f32 per 8-wide k-step, into one accumulator or into a
  fresh fragment every few k-steps that is added to the running sum with
  round to nearest (the kernels' ``add_to``);
* the m16n8k8 fragment maps, lane by lane: P and dS go from an mma's C
  fragment straight into the next mma's A fragment, which works because
  the B operand's k-rows are read in the same permuted order; B columns
  interleaved by n-tile pairs (one 8-byte read for two n-tiles) and the
  epilogue that undoes it; K1's scores with each 8-wide step's D columns
  taken in pairs (one 8-byte read of a K row for b0 and b1);
* the padded shared-memory row strides that make every fragment read hit
  32 distinct banks;
* the causal tile bounds for tiles that need not be square (the JAX
  kernels' ``upper`` and ``lower``), and which tiles need the element-wise
  mask.

The model of K1 as a whole (64-row tiles, online softmax, 3xTF32 products)
is held against the JAX package's flash forward in interpret mode at the
kernel's own tolerance, 1e-5, and the model of K2 (fresh fragments,
truncating accumulators, dS fed C→A lane by lane) against its dQ at 1e-4;
plain TF32 misses both.  On a long sum (1024 keys) one truncating
accumulator drifts measurably further from float64 than the kernels'
fresh fragments, which stay inside the tolerance.
"""
import numpy as np
import pytest

import importlib

import jax.numpy as jnp

from autodist_tpu.ops.flash_attention import \
    flash_attention_with_lse as jflash_lse

pytestmark = pytest.mark.torch_port

jfa = importlib.import_module("autodist_tpu.ops.flash_attention")

TILE = 64          # the kernels' row tile (q rows for K1, keys for K2, K3)
PAD = 4            # floats of padding per shared row
LONG_GROUP = 4     # kLongGroup: k-steps per fresh fragment in long sums
NEG_INF = np.float32(-1e30)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def tf32_rna(x):
    """``cvt.rna.tf32.f32`` on finite f32: add half a TF32 ulp to the
    magnitude bits and clear the low 13 (sign-magnitude, so ties go away
    from zero)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna((np.asarray(x, np.float32) - big)
                         .astype(np.float32))


def _f64_step(x, y):
    return x.astype(np.float64) @ y.astype(np.float64)


def to_f32(x, truncate: bool = False):
    """float64 ``x`` to f32, rounded to nearest or toward zero."""
    x = np.asarray(x, np.float64)
    out = x.astype(np.float32)
    if truncate:
        over = np.abs(out.astype(np.float64)) > np.abs(x)
        out = np.where(over, np.nextafter(out, np.float32(0)), out)
    return out.astype(np.float32)


def mma_f32(a, b, terms: int = 3, group=None, truncate: bool = False,
            acc=None, step=_f64_step):
    """``acc + a [M, K] @ b [K, N]`` as the kernels compute it: per 8-wide
    k-step 3 TF32 mmas (small·big, big·small, big·big), 2 (big·small,
    big·big: for an ``a`` that is exact in TF32, as int8 weights are), or 1
    (plain TF32), each adding its exact products (``step`` of the k-step's
    operands: float64, or the lane-level fragment model) to an f32
    accumulator with one rounding, to nearest or, with ``truncate``, toward
    zero.
    ``group=None``: one accumulator for the whole sum, starting at
    ``acc``; ``group=n``: every n k-steps go to a fresh fragment, which is
    then added to the running sum in f32 with round to nearest."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    pairs = {3: [(a_small, b_big), (a_big, b_small), (a_big, b_big)],
             2: [(a_big, b_small), (a_big, b_big)],
             1: [(a_big, b_big)]}[terms]
    run = (np.zeros((a.shape[0], b.shape[1]), np.float32) if acc is None
           else np.asarray(acc, np.float32))
    nk = a.shape[1]
    per = nk if group is None else 8 * group
    for g0 in range(0, nk, per):
        frag = run if group is None else np.zeros_like(run)
        for k0 in range(g0, min(g0 + per, nk), 8):
            ks = slice(k0, k0 + 8)
            for x, y in pairs:
                frag = to_f32(frag.astype(np.float64)
                              + step(x[:, ks], y[ks]), truncate)
        run = frag if group is None else (run + frag).astype(np.float32)
    return run


def k1_model(q, k, v, causal: bool, terms: int = 3):
    """K1 on one (batch, head): ``q, k, v [T, D]`` f32 -> ``(o, lse)``,
    64-row q and key tiles, online softmax in f32 with the finite -1e30
    sentinel, every product through :func:`mma_f32`."""
    t, d = q.shape
    qs = (q * np.float32(1.0 / np.sqrt(d))).astype(np.float32)
    o = np.zeros((t, d), np.float32)
    lse = np.zeros(t, np.float32)
    for q0 in range(0, t, TILE):
        rows = np.arange(q0, min(q0 + TILE, t))
        m = np.full(len(rows), NEG_INF, np.float32)
        l = np.zeros(len(rows), np.float32)
        acc = np.zeros((len(rows), d), np.float32)
        upper = -(-(q0 + TILE) // TILE) if causal else -(-t // TILE)
        for k0 in range(0, min(upper * TILE, t), TILE):
            keys = np.arange(k0, min(k0 + TILE, t))
            s = mma_f32(qs[rows], k[keys].T.copy(), terms)
            if causal:
                s = np.where(keys[None, :] <= rows[:, None], s, NEG_INF)
            m_new = np.maximum(m, s.max(axis=1))
            corr = np.exp(m - m_new)
            p = np.exp(s - m_new[:, None]).astype(np.float32)
            l = l * corr + p.sum(axis=1, dtype=np.float32)
            acc = acc * corr[:, None] + mma_f32(p, v[keys], terms)
            m = m_new
        lc = np.maximum(l, np.float32(1e-30))
        o[rows] = acc / lc[:, None]
        lse[rows] = m + np.log(lc)
    return o, lse


# m16n8k8 (.tf32) fragments, lane = 4 g + t (PTX ISA, "Matrix Fragments
# for mma.m16n8k8"): A [16, 8] row-major, B [8, 8] (k, n), C [16, 8].
def a_frag(a):
    return [[a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4]]
            for g, t in (divmod(lane, 4) for lane in range(32))]


def b_frag(b):
    return [[b[t, g], b[t + 4, g]]
            for g, t in (divmod(lane, 4) for lane in range(32))]


def c_frag(c):
    return [[c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
             c[g + 8, 2 * t + 1]]
            for g, t in (divmod(lane, 4) for lane in range(32))]


def _unfrag(regs, layout, shape):
    out = np.zeros(shape)
    probe = np.arange(np.prod(shape)).reshape(shape)
    for lane_regs, lane_idx in zip(regs, layout(probe)):
        for val, flat in zip(lane_regs, lane_idx):
            out.flat[flat] = val
    return out


def mma_lanes(a_regs, b_regs, c_regs):
    """One ``mma.m16n8k8`` from the 32 lanes' registers, as the hardware
    reads them: ``D = A B + C`` back in C-fragment registers."""
    a = _unfrag(a_regs, a_frag, (16, 8))
    b = _unfrag(b_regs, b_frag, (8, 8))
    c = _unfrag(c_regs, c_frag, (16, 8))
    return c_frag(a @ b + c)


def store_rows(out_regs, d):
    """The kernels' epilogue (``store_rows`` in the source): lane (g, t)
    writes rows g and g + 8 of a 16 x D accumulator held as D/8 C
    fragments whose B columns were interleaved by n-tile pairs (n-tile
    2m + e, fragment column c is output column 16m + 2c + e): a float4 of
    (2m, c0), (2m + 1, c0), (2m, c1), (2m + 1, c1) at column 16m + 4t; at
    D = 8 one n-tile, natural columns."""
    out = np.full((16, d), np.nan)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for h in (0, 1):
            if d == 8:
                out[g + 8 * h, 2 * t:2 * t + 2] = out_regs[0][lane][2 * h:
                                                                 2 * h + 2]
                continue
            for m in range(d // 16):
                e, o = out_regs[2 * m][lane], out_regs[2 * m + 1][lane]
                out[g + 8 * h, 16 * m + 4 * t:16 * m + 4 * t + 4] = [
                    e[2 * h], o[2 * h], e[2 * h + 1], o[2 * h + 1]]
    return out


def chained_product(p, x, permuted: bool = True):
    """``p [16, 64] @ x [64, D]`` as K1 computes P V and K3 P^T dO and dS^T
    Q: ``p`` is held as the C fragments of 8 earlier mmas (one per 8
    columns) and fed to the A operand straight from those registers
    (``mma_from_c``).  ``permuted``: the kernels' map (a = c0, c2, c1, c3;
    B's k-rows 2t, 2t + 1; B columns interleaved by n-tile pairs, undone by
    :func:`store_rows`); otherwise the registers in their own order against
    B's natural rows t, t + 4."""
    kdim, d = x.shape
    nd = d // 8
    p_regs = [c_frag(p[:, j:j + 8]) for j in range(0, kdim, 8)]
    out = [c_frag(np.zeros((16, 8))) for _ in range(nd)]
    for j, regs in enumerate(p_regs):
        a = [[r[0], r[2], r[1], r[3]] for r in regs] if permuted else regs
        for n in range(nd):
            b = []
            for lane in range(32):
                g, t = divmod(lane, 4)
                rows = (2 * t, 2 * t + 1) if permuted else (t, t + 4)
                col = 16 * (n // 2) + 2 * g + n % 2 if nd > 1 else g
                b.append([x[j * 8 + r, col] for r in rows])
            out[n] = mma_lanes(a, b, out[n])
    return store_rows(out, d)


def scores_from_pairs(q, k):
    """K1's ``S = Q K^T`` for 16 q rows and 8 keys per n-tile: k-step s
    pairs A columns t, t + 4 with D columns 8s + 2t, 8s + 2t + 1, so that
    one 8-byte read of a K row gives b0 and b1."""
    d = q.shape[1]
    out = []
    for n in range(k.shape[0] // 8):
        c = c_frag(np.zeros((16, 8)))
        for s in range(d // 8):
            a, b = [], []
            for lane in range(32):
                g, t = divmod(lane, 4)
                c0 = 8 * s + 2 * t
                a.append([q[g, c0], q[g + 8, c0], q[g, c0 + 1],
                          q[g + 8, c0 + 1]])
                b.append([k[8 * n + g, c0], k[8 * n + g, c0 + 1]])
            c = mma_lanes(a, b, c)
        out.append(_unfrag(c, c_frag, (16, 8)))
    return np.concatenate(out, 1)


def _chained_step(x, y):
    """One 8-wide k-step ``x [M, <=8] @ y [<=8, D]`` with x held as mma C
    fragments and fed to the A operand from registers
    (:func:`chained_product`, 16 rows at a time): exact, in float64."""
    m, kk = x.shape
    xp = np.zeros((-(-m // 16) * 16, 8))
    xp[:m, :kk] = x
    yp = np.zeros((8, y.shape[1]))
    yp[:kk] = y
    return np.concatenate([chained_product(xp[r:r + 16], yp)
                           for r in range(0, len(xp), 16)])[:m]


def k2_model(q, k, v, do, lse, delta, causal: bool, terms: int = 3):
    """K2 on one (batch, head): ``dQ [T, D]`` f32 from ``q, k, v, do [T,
    D]``, ``lse`` and ``delta [T]``.  Per 64-row q tile (K2's 128-row block
    is two of them; rows are independent), 64-key tiles up to K1's causal
    ``upper``: ``S = Q K^T`` (Q pre-scaled) and ``dP = dO V^T`` with a fresh
    fragment per 8-wide step, ``P = exp(S − lse)`` (0 where masked), ``dS
    = P (dP − delta)``, then ``dQ += dS K`` with dS fed C→A lane by lane
    (:func:`chained_product`) and ``LONG_GROUP`` k-steps per fresh
    fragment; every accumulator truncates; dQ times the scale at the
    end."""
    t, d = q.shape
    scale = np.float32(1.0 / np.sqrt(d))
    qs = (q * scale).astype(np.float32)
    dq = np.zeros((t, d), np.float32)
    for q0 in range(0, t, TILE):
        rows = np.arange(q0, min(q0 + TILE, t))
        upper = -(-(q0 + TILE) // TILE) if causal else -(-t // TILE)
        acc = np.zeros((len(rows), d), np.float32)
        for k0 in range(0, min(upper * TILE, t), TILE):
            keys = np.arange(k0, min(k0 + TILE, t))
            s = mma_f32(qs[rows], k[keys].T.copy(), terms, group=1,
                        truncate=True)
            dp = mma_f32(do[rows], v[keys].T.copy(), terms, group=1,
                         truncate=True)
            live = (keys[None, :] <= rows[:, None] if causal
                    else np.ones((len(rows), len(keys)), bool))
            p = np.where(live, np.exp(s - lse[rows, None]),
                         np.float32(0)).astype(np.float32)
            ds = (p * (dp - delta[rows, None])).astype(np.float32)
            acc = mma_f32(ds, k[keys], terms, group=LONG_GROUP,
                          truncate=True, acc=acc, step=_chained_step)
        dq[rows] = acc * scale
    return dq


def _attn_inputs(seed, t, d, mul=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((t, d)).astype(np.float32)
               for _ in range(3))
    return (q * np.float32(mul)).astype(np.float32), k, v


def _reference_f64(q, k, v, causal):
    t, d = q.shape
    s = (q.astype(np.float64) / np.sqrt(d)) @ k.astype(np.float64).T
    if causal:
        s = np.where(np.tri(t, dtype=bool), s, -1e30)
    m = s.max(axis=1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(axis=1, keepdims=True)
    return p @ v.astype(np.float64) / l, (m + np.log(l))[:, 0]


# ---------------------------------------------------------------------------
# cvt.rna.tf32 and the 3xTF32 product
# ---------------------------------------------------------------------------
def _rna_f64(x):
    """Round-to-nearest, ties away, to 11 significant bits, in float64."""
    x = np.asarray(x, np.float64)
    ax = np.abs(x)
    exp = np.floor(np.log2(np.where(ax > 0, ax, 1.0)))
    quantum = np.maximum(2.0 ** (exp - 10), 2.0 ** -136)
    return np.sign(x) * np.floor(ax / quantum + 0.5) * quantum


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.0, 3e4, 1e30])
def test_tf32_rna_rounds_to_nearest_ties_away(scale):
    rng = np.random.default_rng(int(np.log10(scale) + 40))
    x = (rng.standard_normal(20000) * scale).astype(np.float32)
    np.testing.assert_array_equal(tf32_rna(x), _rna_f64(x)
                                  .astype(np.float32))
    # the low 13 bits are clear, so the tensor cores read the value whole
    assert not np.any(tf32_rna(x).view(np.uint32) & np.uint32(0x1FFF))


def test_tf32_rna_ties_go_away_from_zero():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)               # TF32's ulp at 1
    tie = np.array([one + ulp / 2, -(one + ulp / 2), 1 + 3 * ulp / 2],
                   np.float32)
    np.testing.assert_array_equal(
        tf32_rna(tie), np.array([one + ulp, -(one + ulp), 1 + 2 * ulp],
                                np.float32))
    below = np.nextafter(one + ulp / 2, np.float32(0))
    assert tf32_rna(below) == one


@pytest.mark.parametrize("mul", [1.0, 4.0])
def test_three_tf32_products_are_f32_accurate_plain_tf32_is_not(mul):
    """Training-like scores: D 64, Q pre-scaled by 1/8 (times 4 for the
    peaked softmax of the card's split-stress test).  3xTF32 is within
    1e-6 of float64 (norm-wise: max error over max |S|); one TF32 product
    is not within 1e-5."""
    rng = np.random.default_rng(int(mul))
    q = (rng.standard_normal((64, 64)) / 8 * mul).astype(np.float32)
    k = rng.standard_normal((64, 64)).astype(np.float32)
    ref = q.astype(np.float64) @ k.astype(np.float64).T

    def rel(terms):
        s = mma_f32(q, k.T.copy(), terms)
        return np.abs(s - ref).max() / np.abs(ref).max()

    assert rel(3) < 1e-6
    assert rel(1) > 1e-5


def test_split_is_exact_to_two_tf32_words():
    """big + small recovers x to within 2^-22 of |x|: the error the dropped
    small·small term and small's own rounding leave."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(100000).astype(np.float32)
    big, small = split(x)
    err = np.abs(big.astype(np.float64) + small - x) / np.abs(x)
    assert err.max() <= 2.0 ** -22


# ---------------------------------------------------------------------------
# K1 as a whole against the JAX kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t,d,causal,mul", [(50, 16, True, 1.0),
                                            (130, 64, True, 4.0),
                                            (130, 64, False, 1.0),
                                            (70, 8, False, 4.0)])
def test_k1_model_meets_the_kernel_tolerance_against_jax(t, d, causal, mul):
    q, k, v = _attn_inputs(t + d, t, d, mul)
    jo, jlse = jflash_lse(q[None, :, None], k[None, :, None],
                          v[None, :, None], causal, block_q=8, block_k=8,
                          interpret=True)
    jo, jlse = np.asarray(jo)[0, :, 0], np.asarray(jlse)[0, 0]
    o, lse = k1_model(q, k, v, causal)
    np.testing.assert_allclose(o, jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse, jlse, rtol=1e-5, atol=1e-5)
    ro, rlse = _reference_f64(q, k, v, causal)
    np.testing.assert_allclose(o, ro, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse, rlse, rtol=1e-5, atol=1e-5)


def test_k1_model_in_plain_tf32_misses_the_tolerance():
    q, k, v = _attn_inputs(7, 130, 64, 4.0)
    o, _ = k1_model(q, k, v, True, terms=1)
    ro, _ = _reference_f64(q, k, v, True)
    assert np.abs(o - ro).max() > 1e-5 + 1e-5 * np.abs(ro).max()


# ---------------------------------------------------------------------------
# K2 as a whole against the JAX kernel; the truncating accumulator
# ---------------------------------------------------------------------------
def _jax_dq(q, k, v, do, dlse, causal):
    """The JAX ``_fwd`` and ``_bwd`` on one (batch, head) in interpret
    mode, on inputs padded to a multiple of 8 with the true ``kv_len``:
    ``(dq [T, D], lse [T], delta [T])`` with ``delta = rowsum(dO o) −
    dlse`` from the JAX forward's o, the Δ that K2 takes."""
    t = q.shape[0]
    tp = -(-t // 8) * 8
    qt, kt, vt, dot = (jnp.pad(jnp.asarray(x)[None, None],
                               [(0, 0), (0, 0), (0, tp - t), (0, 0)])
                       for x in (q, k, v, do))
    o, lse = jfa._fwd(qt, kt, vt, causal, 8, 8, True, t)
    dl = jnp.pad(jnp.asarray(dlse)[None, None], [(0, 0), (0, 0),
                                                  (0, tp - t)])[..., None]
    dq, _, _ = jfa._bwd(qt, kt, vt, o, lse, dot, causal, 8, 8, True, t,
                        dlse=dl)
    o = np.asarray(o)[0, 0, :t]
    delta = ((do * o).sum(-1, dtype=np.float32) - dlse).astype(np.float32)
    return (np.asarray(dq)[0, 0, :t], np.asarray(lse)[0, 0, :t, 0]
            .astype(np.float32), delta)


def _bwd_inputs(seed, t, d, mul):
    q, k, v = _attn_inputs(seed, t, d, mul)
    rng = np.random.default_rng(seed + 1)
    return (q, k, v, rng.standard_normal((t, d)).astype(np.float32),
            rng.standard_normal(t).astype(np.float32))


@pytest.mark.parametrize("t,d,causal,mul", [(50, 8, True, 1.0),
                                            (50, 16, False, 4.0),
                                            (130, 64, True, 4.0),
                                            (130, 64, False, 1.0),
                                            (130, 16, True, 1.0),
                                            (50, 64, False, 4.0)])
def test_k2_model_meets_the_kernel_tolerance_against_jax(t, d, causal, mul):
    q, k, v, do, dlse = _bwd_inputs(t + d, t, d, mul)
    jdq, lse, delta = _jax_dq(q, k, v, do, dlse, causal)
    dq = k2_model(q, k, v, do, lse, delta, causal)
    np.testing.assert_allclose(dq, jdq, rtol=1e-4, atol=1e-4)


def test_k2_model_in_plain_tf32_misses_the_tolerance():
    q, k, v, do, dlse = _bwd_inputs(194, 130, 64, 4.0)
    jdq, lse, delta = _jax_dq(q, k, v, do, dlse, True)
    dq = k2_model(q, k, v, do, lse, delta, True, terms=1)
    assert np.abs(dq - jdq).max() > 1e-4 + 1e-4 * np.abs(jdq).max()


def test_truncating_accumulator_drifts_on_a_long_sum_fresh_fragments_do_not():
    """dQ's sum over 1024 keys for the last 64 q rows (every key live; q x
    4), from one f32 dS: one truncating accumulator for all 384 mmas
    drifts from float64 several times further than the kernels' fresh
    fragments (LONG_GROUP k-steps each, rounded adds), which stay inside
    the 1e-4 tolerance; rounding to nearest in one accumulator, the
    model's old rule, hides most of the drift."""
    t, d = 1024, 64
    q, k, v, do, _ = _bwd_inputs(11, t, d, 4.0)
    rows = slice(t - 64, t)
    s = (q[rows].astype(np.float64) / np.sqrt(d)) @ k.astype(np.float64).T
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    o = p @ v.astype(np.float64)
    dp = do[rows].astype(np.float64) @ v.astype(np.float64).T
    delta = (do[rows] * o).sum(axis=1, keepdims=True)
    ds = (p * (dp - delta)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    ref = ds.astype(np.float64) @ k.astype(np.float64) * scale

    def err(x):
        return np.abs(x * scale - ref).max() / np.abs(ref).max()

    one = mma_f32(ds, k, truncate=True)
    fresh = mma_f32(ds, k, group=LONG_GROUP, truncate=True)
    nearest = mma_f32(ds, k)
    assert err(one) > 4 * err(fresh)
    assert err(one) > 2 * err(nearest)
    np.testing.assert_allclose(fresh * scale, ref, rtol=1e-4, atol=1e-4)


def test_truncation_rounds_toward_zero():
    x = np.array([1 + 2.0 ** -30, -(1 + 2.0 ** -30), 1 - 2.0 ** -30,
                  3.0, 0.0])
    got = to_f32(x, truncate=True)
    np.testing.assert_array_equal(
        got, np.array([1.0, -1.0, np.nextafter(np.float32(1), 0), 3.0, 0.0],
                      np.float32))
    np.testing.assert_array_equal(to_f32(x), x.astype(np.float32))


# ---------------------------------------------------------------------------
# fragments, banks and tile bounds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [8, 16, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_c_fragment_feeds_a_fragment_with_permuted_b_rows(d, seed):
    """P V (K1) and P^T dO, dS^T Q (K3) from registers, through the
    epilogue's column map: exact on integer-valued inputs, and wrong
    without the permutation."""
    rng = np.random.default_rng(d + 10 * seed)
    p = rng.integers(-8, 9, (16, 64)).astype(np.float64)
    x = rng.integers(-8, 9, (64, d)).astype(np.float64)
    np.testing.assert_array_equal(chained_product(p, x), p @ x)
    assert not np.array_equal(chained_product(p, x, permuted=False), p @ x)


@pytest.mark.parametrize("d", [8, 16, 64])
def test_paired_d_columns_give_the_scores(d):
    """K1's S = Q K^T with D columns 2t, 2t + 1 of each 8-wide step in A
    columns t, t + 4 and B k-rows t, t + 4: exact."""
    rng = np.random.default_rng(d)
    q = rng.integers(-8, 9, (16, d)).astype(np.float64)
    k = rng.integers(-8, 9, (64, d)).astype(np.float64)
    np.testing.assert_array_equal(scores_from_pairs(q, k), q @ k.T)


def _conflict_free(addr, width):
    """A warp's shared-memory read of ``width`` bytes per lane at float
    offsets ``addr(g, t)``: each phase (128 bytes: 32 / (width / 4)
    lanes) must touch 32 distinct banks."""
    words = width // 4
    per_phase = 32 // words
    for p0 in range(0, 32, per_phase):
        banks = set()
        for lane in range(p0, p0 + per_phase):
            g, t = divmod(lane, 4)
            a = addr(g, t)
            assert a % words == 0            # aligned vector read
            banks.update((a + i) % 32 for i in range(words))
        if len(banks) != 32:
            return False
    return True


@pytest.mark.parametrize("d", [8, 16, 64])
def test_padded_shared_rows_make_fragment_reads_conflict_free(d):
    """Every shared-memory fragment read of the kernels hits 32 distinct
    banks per phase with the source's row strides: ``kLd = D + 4`` and
    ``kLdPair = D + 8 - D % 16``; unpadded rows would conflict.  K2 reads
    K at the one stride both ways: as S's B operand (K3's pattern) and as
    dQ's (K1's pattern for V)."""
    ld, ld_pair = d + 4, d + 8 - d % 16
    s = d // 8 - 1                     # the last 8-wide step over D
    reads = [
        # K1: K's b0, b1 pair (row g, cols 8s + 2t, + 1), 8 bytes
        (lambda g, t: g * ld_pair + 2 * t, 8),
        # K3: K/V A and Q/dO B reads (row g, col t; + 4; row + 8), 4 bytes
        (lambda g, t: g * ld + t, 4),
        (lambda g, t: (g + 8) * ld + t + 4, 4),
        # K2: Q's halves and dO as A (rows 16w + g, + 8; cols 8s + t, + 4)
        (lambda g, t: (16 * 7 + g) * ld + 8 * s + t, 4),
        (lambda g, t: (16 * 7 + g + 8) * ld + 8 * s + t + 4, 4),
        # K2: K and V as S's and dP's B (row 8n + g, cols 8s + t, + 4)
        (lambda g, t: (8 * 5 + g) * ld + 8 * s + t, 4),
        (lambda g, t: (8 * 5 + g) * ld + 8 * s + t + 4, 4),
    ]
    if d > 8:   # rows 2t, 2t + 1 of V, dO, Q (K1, K3) and K (K2, dQ's B):
        #         columns 16m + 2g, + 1, 8 bytes
        reads += [(lambda g, t: 2 * t * ld + 2 * g, 8),
                  (lambda g, t: (2 * t + 1) * ld + 16 + 2 * g, 8),
                  (lambda g, t: (8 * 3 + 2 * t + 1) * ld
                   + 16 * (d // 16 - 1) + 2 * g, 8)]
    else:       # D = 8: one n-tile, column g, 4 bytes
        reads += [(lambda g, t: 2 * t * ld + g, 4),
                  (lambda g, t: (2 * t + 1) * ld + g, 4)]
    for addr, width in reads:
        assert _conflict_free(addr, width)
    if d == 64:
        assert not _conflict_free(lambda g, t: g * d + t, 4)
        assert not _conflict_free(lambda g, t: 2 * t * d + 2 * g, 8)


def _k1_upper(qt, bm, bn, nkt):
    return min(nkt, -(-(qt * bm + bm) // bn))


def _k3_lower(kt, bm, bn):
    return (kt * bn) // bm


@pytest.mark.parametrize("bm,bn", [(64, 64), (64, 32), (32, 64), (128, 64)])
@pytest.mark.parametrize("t", [1, 50, 64, 1000, 1024])
def test_causal_tile_bounds_cover_exactly_the_live_tiles(bm, bn, t):
    """K1 visits key tiles [0, upper) of q tile qt and K3 q tiles
    [lower, nqt) of key tile kt: every live (key <= row < T) pair is
    visited, every skipped tile is wholly masked, and a tile off the
    diagonal and the ragged tail needs no element-wise mask (the kernels'
    `edge` test, square tiles being bm = bn = 64)."""
    rows = np.arange(t)
    live = rows[None, :] <= rows[:, None]         # [q, key]
    nkt, nqt = -(-t // bn), -(-t // bm)
    for qt in range(nqt):
        q0 = qt * bm
        block = live[q0:q0 + bm]
        upper = _k1_upper(qt, bm, bn, nkt)
        assert not block[:, upper * bn:].any()
        for kt in range(upper):
            k0 = kt * bn
            edge = k0 + bn - 1 > q0 or k0 + bn > t
            tile = live[q0:q0 + bm, k0:k0 + bn]
            assert edge or tile.all()
    for kt in range(nkt):
        k0 = kt * bn
        lower = _k3_lower(kt, bm, bn)
        assert not live[:lower * bm, k0:k0 + bn].any()
        for qt in range(lower, nqt):
            q0 = qt * bm
            edge = q0 < k0 + bn - 1 or q0 + bm > t or k0 + bn > t
            assert edge or live[q0:q0 + bm, k0:k0 + bn].all()
