// Weight-only int8 matmul for Hopper (sm_90a): out = (x @ q) * scale.
//
// Replaces the TPU kernel autodist_tpu/ops/quant.py:_kernel (entry
// int8_matmul via _int8_matmul_2d).  That kernel holds all of x and one
// [K, block_n] int8 column block in VMEM per grid step, runs one MXU dot
// with f32 accumulation and scales the result columns.
//
// What bounds it on the H100: bytes at decode (M = slots = 8 rows: every
// weight byte is read for 2 * M flops) and f32 CUDA-core operations at
// prefill (M = rows x chunk, several hundred rows).  The point of the op is
// that weights stay int8 in device memory: no dequantized copy is ever
// written, each tile is converted to f32 in shared memory or registers, and
// because the scale is per output column it factors out of the contraction
// and is applied once in the epilogue.
//
// Design (simple and right first), two kernels, each output a sum of f32
// fmaf steps:
//  * skinny (M <= 16, decode): a block owns 128 output columns (one warp
//    wide, four int8 columns per thread: each warp load is 128 contiguous
//    bytes) for all rows; its 8 warps split its rows of K round-robin, x is
//    staged in shared memory 256 columns at a time, and the warps' partial
//    sums are added in a fixed order.  The decode projections have few
//    columns (N = 768 gives 6 column blocks), so K is also split across
//    blocks (gridDim.y) until the card holds about 4 blocks per SM: each
//    split writes its sums to a workspace the wrapper allocates, and a second
//    kernel adds the splits in order and applies the scale.  The partition
//    of K depends on N and K only, never on M, so a row's result is the same
//    at every M <= 16 (the reference generator decodes one row, the engine
//    eight);
//  * tiled (M > 16, prefill): classic 64 x 64 output tiles, K in steps of 32,
//    x and the converted weight tile in shared memory, 4 x 4 outputs per
//    thread.
// Ragged M, N and K are masked.  Later work: wgmma on int8 -> bf16 tiles, TMA
// loads, and the tiled kernel's occupancy at N = 768.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSkinnyM = 16;                // rows the skinny kernel takes
constexpr int kSkinnyVec = 4;               // int8 columns per thread
constexpr int kSkinnyBN = 32 * kSkinnyVec;  // output columns per block
constexpr int kSkinnyWarps = 8;             // warps per block, each a K slice
constexpr int kSkinnyBK = 256;              // x columns staged per step

// Rows [blockIdx.y * rows, +rows) of K for columns [blockIdx.x * 128, +128).
// With one split the scaled result goes to `out`; otherwise the unscaled sum
// goes to partial[blockIdx.y] ([splits, M, N]).  VEC: each thread's four
// weights are one aligned 32-bit load (N % 4 == 0); else four masked bytes.
template <int MT, bool VEC>
__global__ void __launch_bounds__(32 * kSkinnyWarps)
int8_matmul_skinny(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ out,
                   float* __restrict__ partial, int M, int N, int K,
                   int rows) {
  __shared__ float xs[MT][kSkinnyBK];
  __shared__ float red[kSkinnyWarps][kSkinnyBN];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * kSkinnyBN + lane * kSkinnyVec;
  const int kbeg = blockIdx.y * rows;
  const int kend = min(K, kbeg + rows);
  float acc[MT][kSkinnyVec];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kSkinnyVec; ++j) acc[m][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kSkinnyBK) {
    const int kn = min(kSkinnyBK, kend - k0);
    __syncthreads();  // the previous x tile is consumed
    for (int i = threadIdx.x; i < MT * kSkinnyBK; i += blockDim.x) {
      const int m = i / kSkinnyBK;
      const int kk = i - m * kSkinnyBK;
      xs[m][kk] = (m < M && kk < kn) ? x[(size_t)m * K + k0 + kk] : 0.f;
    }
    __syncthreads();
    if (n0 < N) {
#pragma unroll 4
      for (int kk = warp; kk < kn; kk += kSkinnyWarps) {
        const int8_t* row = q + (size_t)(k0 + kk) * N + n0;
        float w[kSkinnyVec];
        if (VEC) {
          const char4 c = *reinterpret_cast<const char4*>(row);
          w[0] = c.x;
          w[1] = c.y;
          w[2] = c.z;
          w[3] = c.w;
        } else {
#pragma unroll
          for (int j = 0; j < kSkinnyVec; ++j)
            w[j] = n0 + j < N ? (float)row[j] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < kSkinnyVec; ++j)
            acc[m][j] = fmaf(xs[m][kk], w[j], acc[m][j]);
      }
    }
  }
  float* dst = gridDim.y == 1 ? out : partial + (size_t)blockIdx.y * M * N;
  const int c = threadIdx.x;
  const int n = blockIdx.x * kSkinnyBN + c;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    __syncthreads();  // the previous row's sums are read
#pragma unroll
    for (int j = 0; j < kSkinnyVec; ++j)
      red[warp][lane * kSkinnyVec + j] = acc[m][j];
    __syncthreads();
    if (c < kSkinnyBN && m < M && n < N) {
      float s = 0.f;
      for (int g = 0; g < kSkinnyWarps; ++g) s += red[g][c];
      dst[(size_t)m * N + n] = gridDim.y == 1 ? s * scale[n] : s;
    }
  }
}

// out[i] = (sum over splits, in order, of partial[split][i]) * scale[n].
__global__ void int8_matmul_split_sum(const float* __restrict__ partial,
                                      const float* __restrict__ scale,
                                      float* __restrict__ out, int M, int N,
                                      int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  float s = 0.f;
  for (int g = 0; g < splits; ++g) s += partial[(size_t)g * M * N + i];
  out[i] = s * scale[i % N];
}

template <int MT>
cudaError_t launch_skinny(const float* x, const int8_t* q, const float* scale,
                          float* out, float* partial, int M, int N, int K,
                          int splits, cudaStream_t s) {
  const dim3 grid((N + kSkinnyBN - 1) / kSkinnyBN, splits);
  const int rows = (K + splits - 1) / splits;
  if (N % kSkinnyVec == 0 && (uintptr_t)q % kSkinnyVec == 0) {
    int8_matmul_skinny<MT, true><<<grid, 32 * kSkinnyWarps, 0, s>>>(
        x, q, scale, out, partial, M, N, K, rows);
  } else {
    int8_matmul_skinny<MT, false><<<grid, 32 * kSkinnyWarps, 0, s>>>(
        x, q, scale, out, partial, M, N, K, rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int total = M * N;
  int8_matmul_split_sum<<<(total + 255) / 256, 256, 0, s>>>(partial, scale,
                                                           out, M, N, splits);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
int8_matmul_tiled(const float* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int M, int N, int K) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  __shared__ float xs[BK][BM + 4];  // transposed x tile
  __shared__ float qs[BK][BN];      // int8 weights converted to f32
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
      const int r = i / BK;
      const int kk = i - r * BK;
      const int gm = m0 + r;
      const int gk = k0 + kk;
      xs[kk][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += kThreads) {
      const int kk = i / BN;
      const int cc = i - kk * BN;
      const int gk = k0 + kk;
      const int gn = n0 + cc;
      qs[kk][cc] = (gk < K && gn < N) ? (float)q[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float w[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = qs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j] * scale[gn];
    }
  }
}

}  // namespace

// x [M, K] f32, q [K, N] int8, scale [N] f32 -> out [M, N] f32, all
// row-major and contiguous.  For M <= 16, `splits` (>= 1) K-splits of the
// skinny kernel, and `partial` an [splits, M, N] f32 workspace (unused when
// splits == 1); both are ignored above 16 rows.  Launches on `stream`,
// allocates nothing, and returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int int8_matmul_f32(const void* x, const void* q,
                               const void* scale, void* out, void* partial,
                               int M, int N, int K, int splits,
                               void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const int8_t* qi = (const int8_t*)q;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  float* p = (float*)partial;
  if (M <= kSkinnyM) {
    if (splits < 1 || (splits > 1 && p == nullptr))
      return (int)cudaErrorInvalidValue;
    cudaError_t err;
    if (M == 1) {
      err = launch_skinny<1>(xf, qi, sc, o, p, M, N, K, splits, s);
    } else if (M <= 2) {
      err = launch_skinny<2>(xf, qi, sc, o, p, M, N, K, splits, s);
    } else if (M <= 4) {
      err = launch_skinny<4>(xf, qi, sc, o, p, M, N, K, splits, s);
    } else if (M <= 8) {
      err = launch_skinny<8>(xf, qi, sc, o, p, M, N, K, splits, s);
    } else {
      err = launch_skinny<16>(xf, qi, sc, o, p, M, N, K, splits, s);
    }
    return (int)err;
  }
  constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_tiled<BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, s>>>(xf, qi, sc, o, M, N, K);
  return (int)cudaGetLastError();
}
