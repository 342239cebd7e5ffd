// Flash attention for Hopper (sm_90a), f32: forward (K1), dQ (K2), dK/dV (K3).
//
// Replaces the TPU kernels of autodist_tpu/ops/flash_attention.py:
//   flash_fwd_f32  <- _fwd_kernel  (entry _fwd, public flash_attention)
//   flash_dq_f32   <- _dq_kernel   (entry _bwd)
//   flash_dkv_f32  <- _dkv_kernel  (entry _bwd)
// Those kernels run one program per (batch, head, row block) on a grid the
// TPU walks in order, stream the other operand's blocks through the MXU and
// keep the online-softmax state (m, l, acc) in VMEM, so the [T, T] score
// matrix never reaches HBM.
//
// Common to all three:
//  * q, k, v, o, dO are read and written in the public [B, T, H, D] layout
//    through strides (rows H * D apart); lse and delta are [B, H, T].  No
//    transposes and no padding: the ragged tail (T not a multiple of the
//    tile) is masked inside the kernels;
//  * masked scores are the finite sentinel -1e30, never -inf, so a masked
//    row stays NaN-free (the TPU kernel's _NEG_INF); o = acc / max(l,
//    1e-30) and lse = m + log(max(l, 1e-30));
//  * no atomics: every output element is summed by one thread in a fixed
//    order, so two backward runs give identical bits.
//
// What bounds them on the H100: operations.  At the training shape (B 8,
// T 1024, H 12, D 64, causal) the forward does two T x T x D products per
// (batch, head), ~12.9 GFLOP after causal halving, against ~100 MB of
// inputs and outputs: ~130 flop per byte.  K2 does three such products and
// K3 four.  On CUDA cores (67 TFLOP/s f32) that is 0.19 / 0.29 / 0.39 ms.
//
// All three: tensor cores, 3xTF32.
//  * Plain TF32 keeps 10 mantissa bits (~3 decimal digits): a score would
//    carry a relative error near 5e-4 and o would miss its 1e-5 check.  So
//    every product is 3xTF32, as the f32 path of PyTorch's memory-efficient
//    attention does (CUTLASS's OpMultiplyAddFastF32): each f32 operand x is
//    split into big = rna(x) and small = rna(x - big), both TF32 (round to
//    nearest, ties away: cvt.rna.tf32.f32's bits, computed with an add and
//    a mask because sm_90 emulates the cvt in four instructions), and
//    mma.sync.m16n8k8 accumulates small*big, then big*small, then big*big.
//    The rounding matters: mma ignores the low 13 bits of a register, so
//    without it big would be a truncation and small wrong.  The f32-accurate
//    rate is a third of the 495 TFLOP/s TF32 peak (0.078 ms for K1, 0.117
//    for K2 and 0.156 for K3 at the training shape), which mma.sync,
//    unlike the warpgroup wgmma, does not reach;
//  * the mma's f32 accumulation truncates.  Summed into one fragment, the
//    3 x T / 8 mmas of P V over T keys drift by ~1e-5 relative (o and dV
//    then miss their checks against the plain version), so each product
//    goes to a fresh fragment that is added to the running sum in f32 with
//    round to nearest: per 8-wide step in the short sums over D (S, dP),
//    per kLongGroup steps in the long ones (P V, dQ, dV, dK);
//  * a warp owns 16 rows (q rows for K1 and K2, keys for K3); K1's block
//    is four warps (64 q rows), K2's eight (128 q rows), K3's eight (128
//    keys).  Scores live in mma C fragments and never leave registers: a
//    16 x 64 tile is 8 n-tiles of 4 f32 per lane.  A row's max and sum come
//    from two xor shuffles inside the lane quad, and each element's
//    exponential is computed once
//    (__expf: the ex2 unit after one multiply, within a few ulp for the
//    arguments that carry weight, far inside the checks);
//  * P (and dS) feed the next product from registers.  The C fragment of
//    m16n8 gives lane (g, t) columns 2t and 2t + 1; the A fragment of
//    m16n8k8 wants columns t and t + 4.  A contraction does not care how
//    its index is labelled inside an 8-wide step, so A column t is taken as
//    column 2t and A column t + 4 as 2t + 1, and the B operand's k-rows are
//    read in the same order (b0 = row 2t, b1 = row 2t + 1): no shuffle and
//    no shared-memory round trip.  The same freedom pairs columns for
//    8-byte reads: the B columns of n-tiles 2m and 2m + 1 interleave (lane
//    g reads columns 16m + 2g and + 1, one per n-tile; the epilogue writes
//    them back in order), and K1's k-step s takes D columns 8s + 2t and
//    8s + 2t + 1 for Q's A and K's B;
//  * the streamed tiles (K and V for K1 and K2; Q, dO, lse and delta for
//    K3) are double-buffered with cp.async: tile i + 1 is in flight while
//    tile i is multiplied.  The 16-byte cp.async.cg with a source size of 0 fills
//    rows at or past T with zeros;
//  * a streamed tile is split once per block, not once per warp: after its
//    copy lands each thread splits the 16-byte chunks it copied in place
//    into their big halves and writes the small halves to a second array
//    (K3 scales Q by 1/sqrt(D) in the same pass, so dS^T Q already carries
//    it; K2 splits its fixed Q tile the same way).  Fragment reads are then plain shared-memory loads.  Row strides
//    of D + 4 floats (D + 8 - D % 16 for K1's K) put every fragment read on
//    32 distinct banks;
//  * K1: Q is pre-scaled, split once and kept in registers for the whole
//    key loop.  Causal blocks stop at ceil((qt * BM + BM) / BN) (the TPU
//    kernel's `upper`); the element-wise mask runs only in the diagonal
//    tile and the ragged tail.  Two stages of K and V and one of their
//    small halves take 105 KB at D = 64, above the 48 KB static limit, so
//    the launch raises the dynamic shared-memory limit first and returns
//    its error; two blocks fit on an SM;
//  * K3: a warp keeps dK and dV (64 registers at D = 64) and the S^T and
//    dP^T tiles of one 64-row q tile (64 more) in registers and loops over
//    q tiles from the causal lower bound (kt * BN) div BM, skipping a tile
//    that lies wholly above its keys.  K's and V's split fragments would
//    need another 128 registers, so K and V stay in shared memory and their
//    A fragments are read and split at each k-step.  171 KB of shared
//    memory at D = 64: one block of eight warps per SM, so the split pass
//    of Q and dO is shared by eight warps;
//  * K2: P = exp(S - lse) is recomputed per key tile and delta =
//    rowsum(dO o) - dlse is an input (the wrapper computes it); dQ = scale
//    * sum dS K.  A warp keeps dQ and the S and dP tiles of one 64-key
//    tile in registers (96 at D = 64) with each row's lse and delta.  Q
//    (pre-scaled) and dO are fixed for the block and land once with K's
//    and V's first tile: Q is split once into big and small halves, and dO
//    stays raw and is split at each k-step, as K3 splits K and V (split
//    fragments of both would take 128 more registers, and both halves of
//    both would not fit beside K and V in shared memory).  K and V stream
//    as in K1; K is read both ways at the one stride D + 4: as S's B
//    operand (row g, columns t and t + 4, K3's pattern) and as dQ's
//    (rows 2t and 2t + 1, paired columns, K1's pattern for V).  Causal
//    blocks stop at K1's `upper`; a warp skips a key tile that lies wholly
//    above its rows and masks element-wise only on the diagonal tile and
//    the ragged tail.  204 KB of shared memory at D = 64: one block of
//    eight warps per SM, so the split pass of K and V is shared by eight
//    warps;
//  * blocks are numbered heaviest causal tile first, so the short ones
//    fill the tail of the grid.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;         // finite masked-score sentinel

// ---------------------------------------------------------------------------
// the parts K1-K3 share: 3xTF32 tensor cores
// ---------------------------------------------------------------------------
constexpr int kTile = 64;                 // q rows of a K1 block; rows of
                                          // every streamed tile
constexpr int kFwdThreads = 128;          // K1: four warps of 16 q rows
constexpr int kDqWarps = 8;               // K2: warps of 16 q rows
constexpr int kDqRows = 16 * kDqWarps;    // K2: q rows a block owns
constexpr int kDqThreads = 32 * kDqWarps;
constexpr int kDkvKeys = 128;             // K3: keys a block owns
constexpr int kDkvThreads = 256;          // K3: eight warps of 16 keys
// 8-wide k-steps whose products share one fresh fragment before the
// rounded add, in the long sums (P V and dQ over keys, dV and dK over q
// rows)
constexpr int kLongGroup = 4;

template <int D>
struct Tc {
  static constexpr int kNd = D / 8;       // 8-wide steps over D
  static constexpr int kNn = kTile / 8;   // 8-wide steps over a q tile
  // Row strides (floats).  kLd = D + 4 (4 mod 8): the reads (row g, col
  // t) and the paired reads (row 2t, cols 2g, 2g + 1) hit distinct banks.
  // kLdPair (8 mod 16): K1's paired reads of K (row g, cols 2t, 2t + 1).
  static constexpr int kLd = D + 4;
  static constexpr int kLdPair = D + 8 - D % 16;
  // K1: two stages of K and V (raw, then big halves), one of small halves
  static constexpr int kFwdSmem = 3 * kTile * (kLdPair + kLd) * 4;
  // K2: Q's big and small halves and dO for the block's q rows; two stages
  // of K and V and one of their small halves
  static constexpr int kDqSmem = (3 * kDqRows + 6 * kTile) * kLd * 4;
  // K3: K and V; two stages of Q and dO and one of their small halves; two
  // stages of lse and delta
  static constexpr int kDkvSmem =
      (2 * kDkvKeys * kLd + 6 * kTile * kLd + 4 * kTile) * 4;
};

// A and B operands of mma.m16n8k8 as TF32 big and small halves.
struct FragA { uint32_t big[4], small[4]; };
struct FragB { uint32_t big[2], small[2]; };

// cvt.rna.tf32.f32 for finite x: add half a TF32 ulp to the magnitude bits
// and clear the low 13 (sign-magnitude, so ties go away from zero).  The
// same bits as the PTX instruction, which sm_90 has no single SASS
// instruction for: ptxas emits a compare, an add, a mask and a select.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

// b0 (k-row t, col g) and b1 (k-row t + 4, col g), already split.
__device__ __forceinline__ FragB frag_b(uint32_t b0, uint32_t b0s,
                                        uint32_t b1, uint32_t b1s) {
  return FragB{{b0, b1}, {b0s, b1s}};
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// p += a * b in 3xTF32, in CUTLASS FastF32's order, on the tensor cores.
__device__ __forceinline__ void mma3(float (&p)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(p, a.small, b.big);
  mma_tf32(p, a.big, b.small);
  mma_tf32(p, a.big, b.big);
}

// c += p in f32, rounded to nearest: p is a fresh fragment holding the
// products of one or a few 8-wide steps, so the mma's truncating
// accumulation only ever rounds a short partial (see the header).
__device__ __forceinline__ void add_to(float (&c)[4], const float (&p)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += p[i];
}

__device__ __forceinline__ uint2 lds64(const float* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ uint32_t lds32(const float* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until all of this thread's committed copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Issue the copy of rows r0 .. r0 + ROWS of one (batch, head) into
// dst [ROWS, LD]; rows at or past T are zero-filled.  `src` points at
// element (b, 0, h, 0); rows are `stride` floats apart.  Thread i copies
// the 16-byte chunks i, i + NT, ...
template <int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t stride, int r0, int T) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += NT) {
    const int r = i / kPerRow;
    const int c = i - r * kPerRow;
    const bool in = r0 + r < T;
    cp_async16(dst + r * LD + c * 4,
               src + (size_t)(in ? r0 + r : 0) * stride + c * 4, in);
  }
}

// After cp_async_wait_all: the chunks this thread copied with stage_rows
// (its own copies are the ones it may read before the block's barrier),
// times `mul`, split in place into their TF32 big halves, with the small
// halves at the same offsets of `small`.
template <int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void split_own_chunks(float* tile, float* small,
                                                 float mul) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += NT) {
    const int r = i / kPerRow;
    const int off = r * LD + (i - r * kPerRow) * 4;
    const float4 x = *reinterpret_cast<const float4*>(tile + off);
    uint4 big, sm;
    split(x.x * mul, big.x, sm.x);
    split(x.y * mul, big.y, sm.y);
    split(x.z * mul, big.z, sm.z);
    split(x.w * mul, big.w, sm.w);
    *reinterpret_cast<uint4*>(tile + off) = big;
    *reinterpret_cast<uint4*>(small + off) = sm;
  }
}

// Issue the copy of vec[r0 .. r0 + kTile) (one (batch, head)'s row of a
// [B, H, T] tensor) into dst; entries at or past T are zero.  Threads
// `first` .. `first` + kTile each copy one 4-byte entry (T need not be a
// multiple of 4, so rows are not 16-byte aligned).
__device__ __forceinline__ void stage_vec(float* dst, const float* vec,
                                          int r0, int T, int first) {
  const int i = threadIdx.x - first;
  if (i >= 0 && i < kTile) {
    const bool in = r0 + i < T;
    cp_async4(dst + i, vec + (in ? r0 + i : 0), in);
  }
}

// The B fragments of n-tiles 2m and 2m + 1 of X^T-style products whose
// k-rows come from an mma C fragment (A column t is row 2t, column t + 4
// row 2t + 1): b0 = X[2t][col], b1 = X[2t + 1][col], with the n-tile pair's
// columns interleaved (n-tile 2m + e, B column g is X column 16m + 2g + e)
// so that one 8-byte read serves both n-tiles.  `r0` points at row 2t's
// element 16m + 2g of the big halves, `s0` at the small halves'.
template <int LD>
__device__ __forceinline__ void frag_b_pair(const float* r0, const float* s0,
                                            FragB& even, FragB& odd) {
  const uint2 b0 = lds64(r0), b1 = lds64(r0 + LD);
  const uint2 b0s = lds64(s0), b1s = lds64(s0 + LD);
  even = frag_b(b0.x, b0s.x, b1.x, b1s.x);
  odd = frag_b(b0.y, b0s.y, b1.y, b1s.y);
}

// Store half h of a 16 x D accumulator (h = 0: the lane's row g, 1: row
// g + 8) to the row `dst`, times `mul`; its columns are interleaved as
// frag_b_pair's (natural for D = 8).
template <int D>
__device__ __forceinline__ void store_rows(float* dst, int t,
                                           const float (&acc)[D / 8][4],
                                           int h, float mul) {
  constexpr int ND = D / 8;
  if constexpr (ND % 2 == 0) {
#pragma unroll
    for (int m = 0; m < ND / 2; ++m)
      *reinterpret_cast<float4*>(dst + 16 * m + 4 * t) = make_float4(
          acc[2 * m][2 * h] * mul, acc[2 * m + 1][2 * h] * mul,
          acc[2 * m][2 * h + 1] * mul, acc[2 * m + 1][2 * h + 1] * mul);
  } else {
    *reinterpret_cast<float2*>(dst + 2 * t) =
        make_float2(acc[0][2 * h] * mul, acc[0][2 * h + 1] * mul);
  }
}

// acc[n] += A X, A a 16 x 64 operand held as the C fragments of 8 earlier
// mmas (p[j] for keys or q rows 8j .. 8j + 8) and X [64, D] in shared
// memory as big halves `xb` and small halves `xs` (row stride LD), columns
// interleaved as frag_b_pair's.  kLongGroup k-steps share each fresh
// fragment.
template <int D, int LD>
__device__ __forceinline__ void mma_from_c(float (&acc)[D / 8][4],
                                           const float (&p)[kTile / 8][4],
                                           const float* xb, const float* xs,
                                           int g, int t) {
  constexpr int ND = D / 8, NN = kTile / 8;
#pragma unroll
  for (int j0 = 0; j0 < NN; j0 += kLongGroup) {
    FragA a[kLongGroup];
#pragma unroll
    for (int u = 0; u < kLongGroup; ++u)
      a[u] = split_a(p[j0 + u][0], p[j0 + u][2], p[j0 + u][1],
                     p[j0 + u][3]);
    if constexpr (ND % 2 == 0) {
#pragma unroll
      for (int m = 0; m < ND / 2; ++m) {
        float pe[4] = {0.f, 0.f, 0.f, 0.f}, po[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < kLongGroup; ++u) {
          const int off = ((j0 + u) * 8 + 2 * t) * LD + 16 * m + 2 * g;
          FragB be, bo;
          frag_b_pair<LD>(xb + off, xs + off, be, bo);
          mma3(pe, a[u], be);
          mma3(po, a[u], bo);
        }
        add_to(acc[2 * m], pe);
        add_to(acc[2 * m + 1], po);
      }
    } else {
      float pn[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < kLongGroup; ++u) {
        const int off = ((j0 + u) * 8 + 2 * t) * LD + g;
        mma3(pn, a[u], frag_b(lds32(xb + off), lds32(xs + off),
                              lds32(xb + off + LD), lds32(xs + off + LD)));
      }
      add_to(acc[0], pn);
    }
  }
}

// K1: one block per (q tile, head, batch), heaviest causal tiles first;
// warp w owns q rows qt * 64 + 16 w .. + 16.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int T, int H, float scale) {
  using C = Tc<D>;
  constexpr int LK = C::kLdPair, LV = C::kLd, ND = C::kNd, NN = C::kNn;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // [2][kTile][LK]: raw, then big
  float* vs = ks + 2 * kTile * LK;        // [2][kTile][LV]
  float* ksm = vs + 2 * kTile * LV;       // [kTile][LK]: small halves
  float* vsm = ksm + kTile * LK;          // [kTile][LV]

  const int nkt = (T + kTile - 1) / kTile;   // q tiles and key tiles
  const int hb = (int)gridDim.x / nkt;       // H * B
  const int qt = nkt - 1 - (int)blockIdx.x / hb;  // longest causal first
  const int h = (int)blockIdx.x % hb % H;
  const int b = (int)blockIdx.x % hb / H;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = qt * kTile;
  const int r0 = q0 + (threadIdx.x / 32) * 16 + g;  // rows r0 and r0 + 8
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * T * H + h) * D;

  const int upper =
      CAUSAL ? min(nkt, (q0 + kTile + kTile - 1) / kTile) : nkt;
  stage_rows<D, LK, kTile, kFwdThreads>(ks, k + base, stride, 0, T);
  stage_rows<D, LV, kTile, kFwdThreads>(vs, v + base, stride, 0, T);
  cp_async_commit();

  // Q, pre-scaled and split, for the whole key loop.  Its k-step s pairs
  // A columns t, t + 4 with D columns 8s + 2t, 8s + 2t + 1, as K's reads.
  FragA qa[ND];
  {
    const float* q_lo = q + base + (size_t)r0 * stride + 2 * t;
    const float* q_hi = q_lo + 8 * stride;
    const bool lo = r0 < T, hi = r0 + 8 < T;
#pragma unroll
    for (int s = 0; s < ND; ++s) {
      const float2 a = lo ? *reinterpret_cast<const float2*>(q_lo + 8 * s)
                          : make_float2(0.f, 0.f);
      const float2 c = hi ? *reinterpret_cast<const float2*>(q_hi + 8 * s)
                          : make_float2(0.f, 0.f);
      qa[s] = split_a(a.x * scale, c.x * scale, a.y * scale, c.y * scale);
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                 // this lane's columns only

  for (int kt = 0; kt < upper; ++kt) {
    const int cur = kt & 1;
    cp_async_wait_all();     // tile kt, the one group in flight, landed
    __syncthreads();         // every warp is done with tile kt - 1
    if (kt + 1 < upper) {
      stage_rows<D, LK, kTile, kFwdThreads>(ks + (cur ^ 1) * kTile * LK,
                                            k + base, stride,
                                            (kt + 1) * kTile, T);
      stage_rows<D, LV, kTile, kFwdThreads>(vs + (cur ^ 1) * kTile * LV,
                                            v + base, stride,
                                            (kt + 1) * kTile, T);
      cp_async_commit();
    }
    float* kc = ks + cur * kTile * LK;
    float* vc = vs + cur * kTile * LV;
    split_own_chunks<D, LK, kTile, kFwdThreads>(kc, ksm, 1.f);
    split_own_chunks<D, LV, kTile, kFwdThreads>(vc, vsm, 1.f);
    __syncthreads();

    // S = Q K^T: b0, b1 = K[key 8n + g][8s + 2t, 8s + 2t + 1]
    float s[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int off = (n * 8 + g) * LK + d * 8 + 2 * t;
        const uint2 bb = lds64(kc + off), bs = lds64(ksm + off);
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(p, qa[d], frag_b(bb.x, bs.x, bb.y, bs.y));
        add_to(s[n], p);
      }
    }
    const int k0 = kt * kTile;
    if ((CAUSAL && k0 + kTile - 1 > q0) || k0 + kTile > T) {
#pragma unroll
      for (int n = 0; n < NN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + n * 8 + 2 * t + (e & 1);
          const int qi = r0 + (e >> 1) * 8;
          if (kj >= T || (CAUSAL && kj > qi)) s[n][e] = kNegInf;
        }
      }
    }

    // online softmax on the fragment: rows r0 (e = 0, 1) and r0 + 8 (2, 3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = __expf(m[r] - mx[r]);
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }

    // O += P V, P straight from the C fragments
    mma_from_c<D, LV>(acc, s, vc, vsm, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = r0 + r * 8;
    if (qi >= T) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    store_rows<D>(o + base + (size_t)qi * stride, t, acc, r, 1.f / lc);
    if (t == 0) lse[((size_t)b * H + h) * T + qi] = m[r] + logf(lc);
  }
}

// K3: one block per (key tile of 128, head, batch), heaviest causal tiles
// first; warp w owns keys kt * 128 + 16 w .. + 16.  Fragments hold S^T and
// dP^T (rows keys, columns q rows).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kDkvThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int T, int H, float scale) {
  using C = Tc<D>;
  constexpr int LD = C::kLd, ND = C::kNd, NN = C::kNn;
  constexpr int kTileFloats = kTile * LD;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [kDkvKeys][LD]
  float* vs = ks + kDkvKeys * LD;            // [kDkvKeys][LD]
  float* qs = vs + kDkvKeys * LD;            // [2][kTile][LD]: raw, then
                                             // big halves of scaled Q
  float* dos = qs + 2 * kTileFloats;         // [2][kTile][LD]
  float* qsm = dos + 2 * kTileFloats;        // [kTile][LD]: small halves
  float* dosm = qsm + kTileFloats;           // [kTile][LD]
  float* ls = dosm + kTileFloats;            // [2][kTile]
  float* dls = ls + 2 * kTile;               // [2][kTile]

  const int hb = (int)gridDim.x / ((T + kDkvKeys - 1) / kDkvKeys);
  const int kt = (int)blockIdx.x / hb;  // early key tiles see most q rows
  const int h = (int)blockIdx.x % hb % H;
  const int b = (int)blockIdx.x % hb / H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int k0 = kt * kDkvKeys;
  const int kw = k0 + warp * 16;             // this warp's first key
  const int kj0 = kw + g;                    // keys kj0 and kj0 + 8
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * T * H + h) * D;
  const float* lse_bh = lse + ((size_t)b * H + h) * T;
  const float* delta_bh = delta + ((size_t)b * H + h) * T;

  const int nqt = (T + kTile - 1) / kTile;
  const int lower = CAUSAL ? k0 / kTile : 0;
  auto stage_q_tile = [&](int qb, int st) {
    stage_rows<D, LD, kTile, kDkvThreads>(qs + st * kTileFloats, q + base,
                                          stride, qb * kTile, T);
    stage_rows<D, LD, kTile, kDkvThreads>(dos + st * kTileFloats,
                                          dout + base, stride, qb * kTile,
                                          T);
    stage_vec(ls + st * kTile, lse_bh, qb * kTile, T, 0);
    stage_vec(dls + st * kTile, delta_bh, qb * kTile, T, kTile);
  };
  stage_rows<D, LD, kDkvKeys, kDkvThreads>(ks, k + base, stride, k0, T);
  stage_rows<D, LD, kDkvKeys, kDkvThreads>(vs, v + base, stride, k0, T);
  stage_q_tile(lower, 0);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  }
  const float* kr = ks + (warp * 16 + g) * LD + t;  // this warp's A rows
  const float* vr = vs + (warp * 16 + g) * LD + t;

  for (int qb = lower; qb < nqt; ++qb) {
    const int cur = (qb - lower) & 1;
    cp_async_wait_all();     // q tile qb, the one group in flight, landed
    __syncthreads();         // every warp is done with q tile qb - 1
    if (qb + 1 < nqt) {
      stage_q_tile(qb + 1, cur ^ 1);
      cp_async_commit();
    }
    float* qc = qs + cur * kTileFloats;
    float* dc = dos + cur * kTileFloats;
    split_own_chunks<D, LD, kTile, kDkvThreads>(qc, qsm, scale);
    split_own_chunks<D, LD, kTile, kDkvThreads>(dc, dosm, 1.f);
    __syncthreads();
    const int q0 = qb * kTile;
    // the whole q tile lies above this warp's keys: nothing to add
    if (CAUSAL && kw > q0 + kTile - 1) continue;
    const float* lc = ls + cur * kTile;
    const float* dlc = dls + cur * kTile;

    // S^T = K Q^T and dP^T = V dO^T: A fragments of K and V split from
    // shared memory; b0, b1 = Q[q 8n + g][8s + t, 8s + t + 4]
    float st[NN][4], dpt[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    }
#pragma unroll 2   // fully unrolled, ptxas spills at D = 64
    for (int d = 0; d < ND; ++d) {
      const float* kd = kr + d * 8;
      const float* vd = vr + d * 8;
      const FragA ka = split_a(kd[0], kd[8 * LD], kd[4], kd[8 * LD + 4]);
      const FragA va = split_a(vd[0], vd[8 * LD], vd[4], vd[8 * LD + 4]);
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int off = (n * 8 + g) * LD + d * 8 + t;
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(p, ka, frag_b(lds32(qc + off), lds32(qsm + off),
                           lds32(qc + off + 4), lds32(qsm + off + 4)));
        add_to(st[n], p);
        float r[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(r, va, frag_b(lds32(dc + off), lds32(dosm + off),
                           lds32(dc + off + 4), lds32(dosm + off + 4)));
        add_to(dpt[n], r);
      }
    }

    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta); columns are q rows
    const bool edge = (CAUSAL && q0 < k0 + kDkvKeys - 1) || q0 + kTile > T
                      || k0 + kDkvKeys > T;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const float2 lv = *reinterpret_cast<const float2*>(lc + n * 8 + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(dlc + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + n * 8 + 2 * t + (e & 1);
        const int kj = kj0 + (e >> 1) * 8;
        const bool ok = !edge || (qi < T && kj < T && (!CAUSAL || kj <= qi));
        const float p =
            ok ? __expf(st[n][e] - ((e & 1) ? lv.y : lv.x)) : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - ((e & 1) ? dl.y : dl.x));
      }
    }

    // dV += P^T dO and dK += dS^T Q, from the C fragments
    mma_from_c<D, LD>(dva, st, dc, dosm, g, t);
    mma_from_c<D, LD>(dka, dpt, qc, qsm, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kj0 + r * 8;
    if (kj >= T) continue;
    store_rows<D>(dk + base + (size_t)kj * stride, t, dka, r, 1.f);
    store_rows<D>(dv + base + (size_t)kj * stride, t, dva, r, 1.f);
  }
}

// K2: one block per (q tile of kDqRows, head, batch), heaviest causal tiles
// first; warp w owns q rows qt * kDqRows + 16 w .. + 16.  Fragments hold S
// and dP (rows q rows, columns keys), then dS in place of dP.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kDqThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int T, int H, float scale) {
  using C = Tc<D>;
  constexpr int LD = C::kLd, ND = C::kNd, NN = C::kNn;
  constexpr int kRowFloats = kDqRows * LD, kTileFloats = kTile * LD;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [kDqRows][LD]: raw, then big
                                             // halves of scaled Q
  float* qsm = qs + kRowFloats;              // [kDqRows][LD]: small halves
  float* dos = qsm + kRowFloats;             // [kDqRows][LD]: dO
  float* ks = dos + kRowFloats;              // [2][kTile][LD]: raw, then big
  float* vs = ks + 2 * kTileFloats;          // [2][kTile][LD]
  float* ksm = vs + 2 * kTileFloats;         // [kTile][LD]: small halves
  float* vsm = ksm + kTileFloats;            // [kTile][LD]

  const int nqt = (T + kDqRows - 1) / kDqRows;
  const int nkt = (T + kTile - 1) / kTile;
  const int hb = (int)gridDim.x / nqt;       // H * B
  const int qt = nqt - 1 - (int)blockIdx.x / hb;  // longest causal first
  const int h = (int)blockIdx.x % hb % H;
  const int b = (int)blockIdx.x % hb / H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = qt * kDqRows;
  const int qw = q0 + warp * 16;             // this warp's first q row
  const int r0 = qw + g;                     // rows r0 and r0 + 8
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * T * H + h) * D;
  const size_t bh = ((size_t)b * H + h) * T;

  const int upper =
      CAUSAL ? min(nkt, (q0 + kDqRows + kTile - 1) / kTile) : nkt;
  stage_rows<D, LD, kDqRows, kDqThreads>(qs, q + base, stride, q0, T);
  stage_rows<D, LD, kDqRows, kDqThreads>(dos, dout + base, stride, q0, T);
  stage_rows<D, LD, kTile, kDqThreads>(ks, k + base, stride, 0, T);
  stage_rows<D, LD, kTile, kDqThreads>(vs, v + base, stride, 0, T);
  cp_async_commit();

  float lr[2], dr[2];                        // lse and delta of the rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    lr[r] = qi < T ? lse[bh + qi] : 0.f;
    dr[r] = qi < T ? delta[bh + qi] : 0.f;
  }
  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  // this warp's A rows: Q's halves, read as they are, and raw dO, split at
  // each k-step (both halves of both would not fit beside K and V)
  const float* qb = qs + (warp * 16 + g) * LD + t;
  const float* qsb = qsm + (warp * 16 + g) * LD + t;
  const float* dob = dos + (warp * 16 + g) * LD + t;

  cp_async_wait_all();
  split_own_chunks<D, LD, kDqRows, kDqThreads>(qs, qsm, scale);
  for (int kt = 0; kt < upper; ++kt) {
    const int cur = kt & 1;
    cp_async_wait_all();     // tile kt, the one group in flight, landed
    __syncthreads();         // every warp is done with tile kt - 1
    if (kt + 1 < upper) {
      stage_rows<D, LD, kTile, kDqThreads>(ks + (cur ^ 1) * kTileFloats,
                                           k + base, stride,
                                           (kt + 1) * kTile, T);
      stage_rows<D, LD, kTile, kDqThreads>(vs + (cur ^ 1) * kTileFloats,
                                           v + base, stride,
                                           (kt + 1) * kTile, T);
      cp_async_commit();
    }
    float* kc = ks + cur * kTileFloats;
    float* vc = vs + cur * kTileFloats;
    split_own_chunks<D, LD, kTile, kDqThreads>(kc, ksm, 1.f);
    split_own_chunks<D, LD, kTile, kDqThreads>(vc, vsm, 1.f);
    __syncthreads();
    const int k0 = kt * kTile;
    // every key of the tile lies above this warp's rows, or no row is live
    if ((CAUSAL && k0 > qw + 15) || qw >= T) continue;

    // S = Q K^T and dP = dO V^T; b0, b1 = K[key 8n + g][8s + t, 8s + t + 4]
    float s[NN][4], dp[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const float* qd = qb + d * 8;
      const float* qsd = qsb + d * 8;
      const FragA qa{{lds32(qd), lds32(qd + 8 * LD), lds32(qd + 4),
                      lds32(qd + 8 * LD + 4)},
                     {lds32(qsd), lds32(qsd + 8 * LD), lds32(qsd + 4),
                      lds32(qsd + 8 * LD + 4)}};
      const float* dd = dob + d * 8;
      const FragA oa = split_a(dd[0], dd[8 * LD], dd[4], dd[8 * LD + 4]);
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int off = (n * 8 + g) * LD + d * 8 + t;
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(p, qa, frag_b(lds32(kc + off), lds32(ksm + off),
                           lds32(kc + off + 4), lds32(ksm + off + 4)));
        add_to(s[n], p);
        float r[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(r, oa, frag_b(lds32(vc + off), lds32(vsm + off),
                           lds32(vc + off + 4), lds32(vsm + off + 4)));
        add_to(dp[n], r);
      }
    }

    // P = exp(S - lse), dS = P (dP - delta), in place of dP
    const bool edge = (CAUSAL && k0 + kTile - 1 > qw) || k0 + kTile > T;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + 2 * t + (e & 1);
        const int qi = r0 + (e >> 1) * 8;
        const bool ok = !edge || (kj < T && (!CAUSAL || kj <= qi));
        const float p = ok ? __expf(s[n][e] - lr[e >> 1]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dr[e >> 1]);
      }
    }

    // dQ += dS K, dS straight from the C fragments
    mma_from_c<D, LD>(dqa, dp, kc, ksm, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + r * 8;
    if (qi >= T) continue;
    store_rows<D>(dq + base + (size_t)qi * stride, t, dqa, r, scale);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *o, *lse_out, *dq, *dk, *dv;
  int B, T, H;
  float scale;
  cudaStream_t stream;
};

// Raises `kernel`'s dynamic shared-memory limit to `bytes` (needed above
// 48 KB) on the current card; returns the runtime's error.
template <typename K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, bool C>
struct Fwd {
  static int run(const Args& a) {
    constexpr int smem = Tc<D>::kFwdSmem;
    if (int err = allow_smem(flash_fwd_kernel<D, C>, smem)) return err;
    const int tiles = (a.T + kTile - 1) / kTile;
    flash_fwd_kernel<D, C><<<tiles * a.H * a.B, kFwdThreads, smem,
                             a.stream>>>(a.q, a.k, a.v, a.o, a.lse_out, a.T,
                                         a.H, a.scale);
    return (int)cudaGetLastError();
  }
};

template <int D, bool C>
struct Dq {
  static int run(const Args& a) {
    constexpr int smem = Tc<D>::kDqSmem;
    if (int err = allow_smem(flash_dq_kernel<D, C>, smem)) return err;
    const int tiles = (a.T + kDqRows - 1) / kDqRows;
    flash_dq_kernel<D, C><<<tiles * a.H * a.B, kDqThreads, smem,
                            a.stream>>>(a.q, a.k, a.v, a.dout, a.lse,
                                        a.delta, a.dq, a.T, a.H, a.scale);
    return (int)cudaGetLastError();
  }
};

template <int D, bool C>
struct Dkv {
  static int run(const Args& a) {
    constexpr int smem = Tc<D>::kDkvSmem;
    if (int err = allow_smem(flash_dkv_kernel<D, C>, smem)) return err;
    const int tiles = (a.T + kDkvKeys - 1) / kDkvKeys;
    flash_dkv_kernel<D, C><<<tiles * a.H * a.B, kDkvThreads, smem,
                             a.stream>>>(a.q, a.k, a.v, a.dout, a.lse,
                                         a.delta, a.dk, a.dv, a.T, a.H,
                                         a.scale);
    return (int)cudaGetLastError();
  }
};

// Runs L<D, causal>::run(a) for the supported head dims and returns its
// error; cudaErrorInvalidValue for any other D.
template <template <int, bool> class L>
int dispatch(int D, bool causal, const Args& a) {
  switch (D) {
    case 8: return causal ? L<8, true>::run(a) : L<8, false>::run(a);
    case 16: return causal ? L<16, true>::run(a) : L<16, false>::run(a);
    case 32: return causal ? L<32, true>::run(a) : L<32, false>::run(a);
    case 64: return causal ? L<64, true>::run(a) : L<64, false>::run(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All tensors contiguous f32 on the card, 16-byte aligned: q, k, v, o, dout,
// dq, dk, dv [B, T, H, D]; lse and delta [B, H, T].  D is one of 8, 16,
// 32, 64.  Each entry launches one kernel on `stream`, allocates nothing,
// and returns the first error of raising the kernel's shared-memory limit
// and of cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int T, int H, int D,
                             int causal, float scale, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  Args a{};
  a.q = (const float*)q; a.k = (const float*)k; a.v = (const float*)v;
  a.o = (float*)o; a.lse_out = (float*)lse;
  a.B = B; a.T = T; a.H = H; a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return dispatch<Fwd>(D, causal != 0, a);
}

extern "C" int flash_dq_f32(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int T, int H,
                            int D, int causal, float scale, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  Args a{};
  a.q = (const float*)q; a.k = (const float*)k; a.v = (const float*)v;
  a.dout = (const float*)dout; a.lse = (const float*)lse;
  a.delta = (const float*)delta; a.dq = (float*)dq;
  a.B = B; a.T = T; a.H = H; a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return dispatch<Dq>(D, causal != 0, a);
}

extern "C" int flash_dkv_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int T, int H, int D, int causal, float scale,
                             void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  Args a{};
  a.q = (const float*)q; a.k = (const float*)k; a.v = (const float*)v;
  a.dout = (const float*)dout; a.lse = (const float*)lse;
  a.delta = (const float*)delta; a.dk = (float*)dk; a.dv = (float*)dv;
  a.B = B; a.T = T; a.H = H; a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return dispatch<Dkv>(D, causal != 0, a);
}
