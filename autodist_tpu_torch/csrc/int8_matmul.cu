// Weight-only int8 matmul for Hopper (sm_90a): out = (x @ q) * scale.
//
// Replaces the TPU kernel autodist_tpu/ops/quant.py:_kernel (entry
// int8_matmul via _int8_matmul_2d).  That kernel holds all of x and one
// [K, block_n] int8 column block in VMEM per grid step, runs one MXU dot
// with f32 accumulation and scales the result columns.
//
// What bounds it on the H100: bytes at decode (M = slots = 8 rows: every
// weight byte is read for 2 * M flops) and operations at prefill (M = rows
// x chunk, up to 2048).  The weights stay int8 in device memory: no
// dequantized copy is ever written, and because the scale is per output
// column it factors out of the contraction and is applied once in the
// epilogue.
//
// Both kernels run on the tensor cores in 2xTF32 (mma.sync.m16n8k8):
//  * an int8 value is exact in TF32, so only x is split, into hi =
//    rna(x) and lo = rna(x - hi) (cvt.rna.tf32.f32's bits by an add and a
//    mask), and x . q = lo . q + hi . q: two mmas where f32 operands need
//    three.  x's residual past hi + lo is ~2^-22 of x, the size of an f32
//    rounding;
//  * the product is computed transposed, out^T = q^T x^T: q^T is the A
//    operand (16 output columns of an m-tile) and x the B operand (8 rows
//    of an n-tile), so a decode batch of 8 rows wastes no mma row;
//  * int8 -> f32 without the I2F pipe: a byte b becomes the float with
//    bits 0x4B000000 | (b ^ 0x80), which is 2^23 + 128 + b, minus
//    8388736.0f (one PRMT and one FADD, both full rate);
//  * k-step pairing: A column t and t + 4 take k rows 2t and 2t + 1, and
//    B's k rows follow, so a lane's x values are two neighbouring k
//    (interleaved hi/lo in shared memory: one 16-byte read) and its q
//    bytes two neighbouring rows of q;
//  * A rows: the lane's chunk of a q row holds 2 * MT bytes (columns
//    2 MT g ..); m-tile i takes bytes 2i (A row g) and 2i + 1 (A row
//    g + 8), so the lane's C fragments cover 2 MT neighbouring output
//    columns of x rows 2t and 2t + 1;
//  * the mma's f32 accumulation truncates, so each group of kGroup k-steps
//    goes to a fresh fragment that is added to the running sum in f32
//    with round to nearest (as in the flash kernels);
//  * every output element is summed in a fixed order (k-steps in order
//    within a group, groups in order; the skinny kernel's warp and cluster
//    partials in rank order): two launches give identical bits.
//
// Tiled (prefill): a block of 2 x 2 warps, a warp MT m-tiles (16 MT output
// columns) by NT n-tiles (8 NT rows of x); the wrapper picks (MT, NT) from
// (4, 4), (4, 2), (2, 2) so the grid fills the card.  x (f32) and q (int8)
// tiles of BK k rows stream through a cp.async pipeline (BK 64 and 4
// stages for the two small tiles, whose few blocks each walk all of K;
// BK 32 and 3 stages for the large one); each x tile is split once per
// block right after it lands, into [row][k][hi, lo] (row stride 2 BK + 16
// floats: the 16-byte fragment reads hit 32 banks), and q stays int8 in
// shared memory (row stride BN + 16 bytes: conflict-free) and is
// converted in registers.  Where the wrapper asks (a long K against few
// columns), K is split over a cluster of blocks along gridDim.z in whole
// units of kSplitUnit rows, and the ranks' partials are added through
// distributed shared memory in rank order.  The split depends on N and K
// only and k runs in a fixed order in groups of kGroup k-steps, so a
// row's result is the same at every M and in every tile shape.
//
// Skinny (decode, M <= 16 rows per slab of gridDim.z): one launch, no
// workspace.  A block of 8 warps owns 128 output columns; each warp a
// contiguous slice of k-steps, each lane 16-byte streaming loads of 16
// columns of two q rows (ld.global.nc, kGroup k-steps in flight).  K is
// split over the warps of a thread-block cluster of up to 8 blocks along
// gridDim.y: the warps' partials are added in warp order in shared memory,
// the blocks' through distributed shared memory in rank order, and each
// rank scales and stores its share of the outputs.  The partition of K
// depends on N and K only (the wrapper's cluster size), never on M, so a
// row's result is the same at every M (the reference generator decodes
// one row, the engine eight).
//
// Ragged M, N and K are masked: the vector paths need N % 16 == 0,
// K % 4 == 0 and 16-byte aligned x and q; other shapes take byte- and
// element-wise loads into the same layouts.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 4;          // k-steps per fresh fragment
constexpr int kTiledThreads = 128;      // 2 x 2 warps
constexpr int kSplitUnit = 64;          // tiled: K splits at multiples
constexpr int kSkinnyWarps = 8;
constexpr int kSkinnyThreads = 32 * kSkinnyWarps;
constexpr int kSkinnyCols = 128;        // output columns per skinny block
constexpr int kSkinnyRows = 16;         // x rows per slab (gridDim.z)
constexpr int kRedLd = kSkinnyCols + 4; // partial-sum row stride (floats)

// cvt.rna.tf32.f32 for finite x (see flash_attention.cu).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Four int8 (the bytes of w) as four exact floats: 0x4B0000xx with
// xx = b ^ 0x80 is 2^23 + 128 + b.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of MT m-tiles from the lane's 2 MT converted bytes of q rows
// 2t (f0) and 2t + 1 (f1): m-tile i is bytes 2i (A row g) and 2i + 1 (A
// row g + 8); A column t is row 2t, column t + 4 row 2t + 1.
template <int MT>
__device__ __forceinline__ void frag_a(const float* f0, const float* f1,
                                       uint32_t (&a)[MT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    a[i][0] = __float_as_uint(f0[2 * i]);
    a[i][1] = __float_as_uint(f0[2 * i + 1]);
    a[i][2] = __float_as_uint(f1[2 * i]);
    a[i][3] = __float_as_uint(f1[2 * i + 1]);
  }
}

// p += q^T x for one k-step: lo first, then hi.
__device__ __forceinline__ void mma2(float (&p)[4], const uint32_t (&a)[4],
                                     uint32_t hi0, uint32_t lo0, uint32_t hi1,
                                     uint32_t lo1) {
  mma_tf32(p, a, lo0, lo1);
  mma_tf32(p, a, hi0, hi1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// tiled (prefill)
// ---------------------------------------------------------------------------
template <int MT, int NT, int BK, int STAGES>
struct Tiled {
  static constexpr int kMT = MT, kNT = NT;
  static constexpr int kBK = BK;            // k rows per tile
  static constexpr int kStages = STAGES;    // cp.async pipeline depth
  static constexpr int kBN = 2 * 16 * MT;   // output columns per block
  static constexpr int kBM = 2 * 8 * NT;    // rows of x per block
  static constexpr int kLdRaw = BK + 4;     // raw x row stride (floats)
  static constexpr int kLdSplit = 2 * BK + 16;   // split x: 16 mod 32
  static constexpr int kLdQ = kBN + 16;     // q row stride (bytes)
  static constexpr int kSmem = (STAGES * kBM * kLdRaw + kBM * kLdSplit) * 4
                               + STAGES * BK * kLdQ;
  static_assert(BK % (8 * kGroup) == 0, "a tile is whole groups");
};

// Tile kt of x (rows m0.., k0..) and q (k0.., columns n0..) into stage
// buffers: 16-byte cp.async with zero fill (VEC), or plain loads.
template <typename C, bool VEC>
__device__ __forceinline__ void tiled_load(float* xr, uint8_t* qs,
                                           const float* x, const int8_t* q,
                                           int M, int N, int K, int m0,
                                           int n0, int k0) {
  constexpr int BK = C::kBK, LDR = C::kLdRaw;
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < C::kBM * (BK / 4); i += kTiledThreads) {
      const int r = i / (BK / 4), c = i % (BK / 4);
      const bool in = m0 + r < M && k0 + 4 * c < K;
      cp_async16(xr + r * LDR + 4 * c,
                 in ? x + (size_t)(m0 + r) * K + k0 + 4 * c : x, in);
    }
    for (int i = threadIdx.x; i < BK * (C::kBN / 16); i += kTiledThreads) {
      const int r = i / (C::kBN / 16), c = i % (C::kBN / 16);
      const bool in = k0 + r < K && n0 + 16 * c < N;
      cp_async16(qs + r * C::kLdQ + 16 * c,
                 in ? q + (size_t)(k0 + r) * N + n0 + 16 * c : q, in);
    }
  } else {
    for (int i = threadIdx.x; i < C::kBM * BK; i += kTiledThreads) {
      const int r = i / BK, kk = i % BK;
      xr[r * LDR + kk] = (m0 + r < M && k0 + kk < K)
                             ? x[(size_t)(m0 + r) * K + k0 + kk] : 0.f;
    }
    for (int i = threadIdx.x; i < BK * C::kBN; i += kTiledThreads) {
      const int r = i / C::kBN, c = i % C::kBN;
      qs[r * C::kLdQ + c] = (k0 + r < K && n0 + c < N)
          ? (uint8_t)q[(size_t)(k0 + r) * N + n0 + c] : (uint8_t)0;
    }
  }
}

template <typename C, bool VEC>
__global__ void __launch_bounds__(kTiledThreads)
int8_matmul_tiled(const float* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int M, int N, int K) {
  constexpr int MT = C::kMT, NT = C::kNT, BK = C::kBK, NS = C::kStages;
  constexpr int BM = C::kBM, BN = C::kBN, LDQ = C::kLdQ;
  constexpr int LDR = C::kLdRaw, LDS = C::kLdSplit;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xraw = reinterpret_cast<float*>(smem);     // [NS][BM][LDR]
  float* xsp = xraw + NS * BM * LDR;                 // [BM][LDS]
  uint8_t* qs = reinterpret_cast<uint8_t*>(xsp + BM * LDS);  // [NS][BK][LDQ]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wc = (warp & 1) * 16 * MT;   // the warp's first column in block
  const int wr = (warp >> 1) * 8 * NT;   // its first row of x in the block
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  // this cluster rank's share of K, in whole units of kSplitUnit k rows
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int per = ((K + kSplitUnit - 1) / kSplitUnit + cs - 1) / cs;
  const int kbeg = min(K, rank * per * kSplitUnit);
  const int kend = min(K, kbeg + per * kSplitUnit);
  const int ktiles = (kend - kbeg + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < ktiles)
      tiled_load<C, VEC>(xraw + s * BM * LDR, qs + s * BK * LDQ, x, q, M, N,
                         K, m0, n0, kbeg + s * BK);
    cp_async_commit();
  }
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<NS - 2>();        // tile kt, this thread's copies
    __syncthreads();                // everyone's copies; tile kt - 1 done
    const int nxt = kt + NS - 1;
    if (nxt < ktiles)
      tiled_load<C, VEC>(xraw + (nxt % NS) * BM * LDR,
                         qs + (nxt % NS) * BK * LDQ, x, q, M, N, K, m0, n0,
                         kbeg + nxt * BK);
    cp_async_commit();
    // split x once per block: [row][k][hi, lo]
    const float* xr = xraw + (kt % NS) * BM * LDR;
    for (int i = threadIdx.x; i < BM * (BK / 4); i += kTiledThreads) {
      const int r = i / (BK / 4), c = i % (BK / 4);
      const float4 v = *reinterpret_cast<const float4*>(xr + r * LDR + 4 * c);
      uint4 a, b;
      split(v.x, a.x, a.y);
      split(v.y, a.z, a.w);
      split(v.z, b.x, b.y);
      split(v.w, b.z, b.w);
      *reinterpret_cast<uint4*>(xsp + r * LDS + 8 * c) = a;
      *reinterpret_cast<uint4*>(xsp + r * LDS + 8 * c + 4) = b;
    }
    __syncthreads();

    const uint8_t* qt = qs + (kt % NS) * BK * LDQ + wc + 2 * MT * g;
    // a fresh fragment per group; the tile's groups are independent
    // chains of mmas, added to acc in order at the end of the tile
    constexpr int G = BK / (8 * kGroup);
    float p[G][MT][NT][4];
#pragma unroll
    for (int u = 0; u < G; ++u)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          p[u][i][j][0] = p[u][i][j][1] = p[u][i][j][2] = p[u][i][j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      float f0[2 * MT], f1[2 * MT];
      const uint8_t* r0 = qt + (8 * s + 2 * t) * LDQ;
      if constexpr (MT == 4) {    // one 8-byte read per row
        const uint2 u0 = *reinterpret_cast<const uint2*>(r0);
        const uint2 u1 = *reinterpret_cast<const uint2*>(r0 + LDQ);
        i8x4_to_f32(u0.x, f0);
        i8x4_to_f32(u0.y, f0 + 4);
        i8x4_to_f32(u1.x, f1);
        i8x4_to_f32(u1.y, f1 + 4);
      } else {
        static_assert(MT == 2, "tiled warps take 2 or 4 m-tiles");
        i8x4_to_f32(*reinterpret_cast<const uint32_t*>(r0), f0);
        i8x4_to_f32(*reinterpret_cast<const uint32_t*>(r0 + LDQ), f1);
      }
      uint32_t a[MT][4];
      frag_a<MT>(f0, f1, a);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint4 b = *reinterpret_cast<const uint4*>(
            xsp + (wr + 8 * j + g) * LDS + 16 * s + 4 * t);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma2(p[s / kGroup][i][j], a[i], b.x, b.y, b.z, b.w);
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += p[u][i][j][e];
  }

  // Lane (g, t) holds columns c0 .. c0 + 2 MT of rows 2t and 2t + 1 of
  // each n-tile: column c0 + 2i + h is acc[i][j][2h + e] for row 2t + e.
  const int c0 = n0 + wc + 2 * MT * g;
  if (cs == 1) {
    float sc[2 * MT];
#pragma unroll
    for (int c = 0; c < 2 * MT; ++c) sc[c] = c0 + c < N ? scale[c0 + c] : 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + wr + 8 * j + 2 * t + e;
        if (row >= M) continue;
        float v[2 * MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          v[2 * i] = acc[i][j][e] * sc[2 * i];
          v[2 * i + 1] = acc[i][j][2 + e] * sc[2 * i + 1];
        }
        float* dst = out + (size_t)row * N + c0;
        if (VEC) {
          if (c0 < N) {
#pragma unroll
            for (int c = 0; c < 2 * MT; c += 4)
              *reinterpret_cast<float4*>(dst + c) =
                  make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < 2 * MT; ++c)
            if (c0 + c < N) dst[c] = v[c];
        }
      }
    }
    return;
  }
  // K split over the cluster: each rank's unscaled [BM][BN] partial in its
  // shared memory, then each rank adds a share of the elements over the
  // ranks in order, scales and stores them.
  constexpr int LDP = BN + 4;
  float* part = reinterpret_cast<float*>(smem);
  __syncthreads();                  // the pipeline's buffers are free
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float* dst = part + (wr + 8 * j + 2 * t + e) * LDP + wc + 2 * MT * g;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        dst[2 * i] = acc[i][j][e];
        dst[2 * i + 1] = acc[i][j][2 + e];
      }
    }
  }
  cluster.sync();
  for (int i = rank * kTiledThreads + threadIdx.x; i < BM * BN;
       i += cs * kTiledThreads) {
    const int r = i / BN, c = i % BN;
    if (m0 + r >= M || n0 + c >= N) continue;
    float sum = 0.f;
    for (int b = 0; b < cs; ++b)
      sum += cluster.map_shared_rank(part, b)[r * LDP + c];
    out[(size_t)(m0 + r) * N + n0 + c] = sum * scale[n0 + c];
  }
  cluster.sync();                   // no block leaves while it is read
}

// ---------------------------------------------------------------------------
// skinny (decode)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint4 ld_stream16(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// 16 bytes of q row k from column col (zeros past K or N).
template <bool VEC>
__device__ __forceinline__ uint4 load_q16(const int8_t* q, int k, int col,
                                          int N, int K) {
  if (VEC) {
    return (k < K && col < N) ? ld_stream16(q + (size_t)k * N + col)
                              : make_uint4(0, 0, 0, 0);
  }
  uint32_t w[4] = {0, 0, 0, 0};
  if (k < K) {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (col + b < N)
        w[b / 4] |= (uint32_t)(uint8_t)q[(size_t)k * N + col + b]
                    << (8 * (b % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Rows [blockIdx.z * 16, + 16) of x against columns [blockIdx.x * 128,
// + 128); the cluster's blocks (gridDim.y) and their warps split the
// k-steps, `per` each.  NT8: n-tiles of 8 rows (1 for M <= 8, else 2).
template <int NT8, bool VEC>
__global__ void __launch_bounds__(kSkinnyThreads)
int8_matmul_skinny(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int M, int N, int K, int per) {
  constexpr int R = 8 * NT8;                 // rows a warp's partial holds
  extern __shared__ __align__(16) float red[];   // [warps][R][kRedLd]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.z * kSkinnyRows;
  const int rows = min(kSkinnyRows, M - m0);
  const float* xb = x + (size_t)m0 * K;
  const int n0 = blockIdx.x * kSkinnyCols;
  const int col = n0 + 16 * g;
  const int ksteps = (K + 7) / 8;
  const int s0 = (rank * kSkinnyWarps + warp) * per;
  const int s1 = min(ksteps, s0 + per);

  float acc[8][NT8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int sb = s0; sb < s1; sb += kGroup) {
    uint4 w0[kGroup], w1[kGroup];
    float xv[kGroup][NT8][2];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {     // every load of the group first
      const int k = 8 * (sb + u) + 2 * t;
      const bool live = sb + u < s1;
      w0[u] = load_q16<VEC>(q, live ? k : K, col, N, K);
      w1[u] = load_q16<VEC>(q, live ? k + 1 : K, col, N, K);
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int r = 8 * j + g;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          xv[u][j][e] = (live && r < rows && k + e < K)
                            ? __ldg(xb + (size_t)r * K + k + e) : 0.f;
      }
    }
    float p[8][NT8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
        p[i][j][0] = p[i][j][1] = p[i][j][2] = p[i][j][3] = 0.f;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      float f0[16], f1[16];
      i8x4_to_f32(w0[u].x, f0);
      i8x4_to_f32(w0[u].y, f0 + 4);
      i8x4_to_f32(w0[u].z, f0 + 8);
      i8x4_to_f32(w0[u].w, f0 + 12);
      i8x4_to_f32(w1[u].x, f1);
      i8x4_to_f32(w1[u].y, f1 + 4);
      i8x4_to_f32(w1[u].z, f1 + 8);
      i8x4_to_f32(w1[u].w, f1 + 12);
      uint32_t a[8][4];
      frag_a<8>(f0, f1, a);
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        uint32_t hi0, lo0, hi1, lo1;
        split(xv[u][j][0], hi0, lo0);
        split(xv[u][j][1], hi1, lo1);
#pragma unroll
        for (int i = 0; i < 8; ++i) mma2(p[i][j], a[i], hi0, lo0, hi1, lo1);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += p[i][j][e];
  }

  // The warp's partial: row 8j + 2t + e, column 16g + 2i + h is
  // acc[i][j][2h + e].
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float* dst = red + (warp * R + 8 * j + 2 * t + e) * kRedLd + 16 * g;
#pragma unroll
      for (int v = 0; v < 4; ++v)
        *reinterpret_cast<float4*>(dst + 4 * v) = make_float4(
            acc[2 * v][j][e], acc[2 * v][j][2 + e], acc[2 * v + 1][j][e],
            acc[2 * v + 1][j][2 + e]);
    }
  }
  __syncthreads();
  // the block's partial, warps in order, into warp 0's rows
  for (int i = threadIdx.x; i < rows * kSkinnyCols; i += kSkinnyThreads) {
    const int r = i / kSkinnyCols, c = i % kSkinnyCols;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kSkinnyWarps; ++w) s += red[(w * R + r) * kRedLd + c];
    red[r * kRedLd + c] = s;
  }
  cluster.sync();   // every block's partial is ready
  for (int i = rank * kSkinnyThreads + threadIdx.x; i < rows * kSkinnyCols;
       i += cs * kSkinnyThreads) {
    const int r = i / kSkinnyCols, c = i % kSkinnyCols;
    if (n0 + c >= N) continue;
    float s = 0.f;
    for (int b = 0; b < cs; ++b)
      s += cluster.map_shared_rank(red, b)[r * kRedLd + c];
    out[(size_t)(m0 + r) * N + n0 + c] = s * scale[n0 + c];
  }
  cluster.sync();   // no block leaves while another reads its partial
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` where that is
// above the 48 KB default, once per card: `raised` is the kernel's own
// record (each instantiation has one size).
constexpr int kMaxDevices = 16;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       bool (&raised)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && raised[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  return err;
}

template <int NT8, bool VEC>
cudaError_t launch_skinny(const float* x, const int8_t* q, const float* sc,
                          float* o, int M, int N, int K, int cluster,
                          cudaStream_t s) {
  auto kernel = int8_matmul_skinny<NT8, VEC>;
  const size_t smem = sizeof(float) * kSkinnyWarps * 8 * NT8 * kRedLd;
  static bool raised[kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, smem, raised);
  if (err != cudaSuccess) return err;
  const int ksteps = (K + 7) / 8;
  const int slices = cluster * kSkinnyWarps;
  const int per = (ksteps + slices - 1) / slices;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kSkinnyCols - 1) / kSkinnyCols, cluster,
                     (M + kSkinnyRows - 1) / kSkinnyRows);
  cfg.blockDim = dim3(kSkinnyThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, q, sc, o, M, N, K, per);
}

template <typename C, bool VEC>
cudaError_t launch_tiled(const float* x, const int8_t* q, const float* sc,
                         float* o, int M, int N, int K, int split,
                         cudaStream_t s) {
  auto kernel = int8_matmul_tiled<C, VEC>;
  static bool raised[kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, C::kSmem, raised);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + C::kBN - 1) / C::kBN, (M + C::kBM - 1) / C::kBM,
                     split);
  cfg.blockDim = dim3(kTiledThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, q, sc, o, M, N, K);
}

// The tiled variants, smallest block first.  The small grids (prefill at
// N = 768 and 3072) walk K serially in few blocks, so their tiles are 64 k
// rows deep with 4 stages in flight; the large one keeps 32-row tiles and
// 3 stages, so two blocks share an SM.
using TiledS = Tiled<2, 2, 64, 4>;
using TiledM = Tiled<4, 2, 64, 4>;
using TiledL = Tiled<4, 4, 32, 3>;

template <bool VEC>
cudaError_t dispatch(const float* x, const int8_t* q, const float* sc,
                     float* o, int M, int N, int K, int variant, int cluster,
                     cudaStream_t s) {
  switch (variant) {
    case 0:
      return M <= 8 ? launch_skinny<1, VEC>(x, q, sc, o, M, N, K, cluster, s)
                    : launch_skinny<2, VEC>(x, q, sc, o, M, N, K, cluster, s);
    case 1:
      return launch_tiled<TiledS, VEC>(x, q, sc, o, M, N, K, cluster, s);
    case 2:
      return launch_tiled<TiledM, VEC>(x, q, sc, o, M, N, K, cluster, s);
    case 3:
      return launch_tiled<TiledL, VEC>(x, q, sc, o, M, N, K, cluster, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, K] f32, q [K, N] int8, scale [N] f32 -> out [M, N] f32, all
// row-major and contiguous.  `variant` 0: the skinny kernel, in slabs of
// 16 rows; 1, 2, 3: the tiled kernel with warp tiles of (m-tiles, n-tiles)
// (2, 2), (4, 2), (4, 4).  Either splits K over a cluster of `cluster`
// (1..8) blocks.  Launches once on `stream`, allocates nothing, and returns the
// launch's error (0 = launched).
extern "C" int int8_matmul_f32(const void* x, const void* q,
                               const void* scale, void* out, int M, int N,
                               int K, int variant, int cluster,
                               void* stream) {
  if (M == 0 || N == 0) return 0;
  if (cluster < 1 || cluster > 8) return (int)cudaErrorInvalidValue;
  const bool vec = N % 16 == 0 && K % 4 == 0 && (uintptr_t)x % 16 == 0
                   && (uintptr_t)q % 16 == 0;
  const float* xf = (const float*)x;
  const int8_t* qi = (const int8_t*)q;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(vec ? dispatch<true>(xf, qi, sc, o, M, N, K, variant,
                                    cluster, s)
                   : dispatch<false>(xf, qi, sc, o, M, N, K, variant,
                                     cluster, s));
}
