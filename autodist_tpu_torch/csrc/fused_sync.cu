// The two kernels of the explicit bucketed training step, for Hopper
// (sm_90a), f32: the numerics guard's statistics (K4) and the fused ZeRO-1
// Adam shard update (K5).
//
// ---------------------------------------------------------------------------
// K4 detect_stats_f32: non-finite count and sum of squares of a flat vector.
//
// Replaces the TPU kernel autodist_tpu/ops/fused_kernels.py:_stats_kernel
// (entry fused_detect_stats).  That kernel walks a sequential grid over
// (64, 128) tiles of a zero-padded copy and carries the two sums in its
// output block from one grid step to the next.
//
// What bounds it on the H100: bytes.  It reads each element once (4 bytes)
// and does one multiply-add and one class test on it.
//
// Design:
//  * blocks run in no order, so each block reduces its own grid-strided
//    share of the vector; the count is an integer per thread and per block
//    (exact), the sum of squares f32 per thread, then a warp-shuffle tree
//    and a shared-memory tree inside the block;
//  * each block writes its two partials to a scratch buffer the wrapper
//    allocates, and a second launch of one block sums them in a fixed
//    order.  No float atomics: the result depends on n only and two runs
//    give the same bits.  The finite bit comes from the integer count, so
//    it is exact;
//  * the block count is a function of n alone (never of the SMs seen at run
//    time), at most kStatsMaxBlocks;
//  * 16-byte loads where the pointer is aligned, the ragged tail masked in
//    the same loop (no padding copy);
//  * NaN and Inf propagate into the sum of squares, as in the TPU kernel
//    (-Inf squares to +Inf; NaN + Inf is NaN).
//
// ---------------------------------------------------------------------------
// K5 adam_update_f32: g <- g * mult; m <- (1-b1) g + b1 m;
// v <- (1-b2) g^2 + b2 v; p <- p - lr (m / bc1) / (sqrt(v / bc2) + eps).
//
// Replaces the TPU kernel autodist_tpu/ops/fused_kernels.py:_adam_kernel
// (entry fused_adam_update): the ZeRO-1 shard update with the loss-scale
// unscale and the global-norm clip folded into one multiplier.
//
// What bounds it on the H100: bytes, 28 per element (read p, g, m, v; write
// p, m, v), against ~15 operations per element.
//
// Design:
//  * one grid-stride elementwise pass, 16-byte vector loads and stores when
//    all seven pointers are aligned, a scalar tail;
//  * the three step scalars (mult, bc1, bc2) come in through a device
//    pointer (the wrapper computes them on the card from the guard's
//    multiplier and the Adam count), so nothing waits for the host;
//  * out of place, as the TPU kernel: the wrapper allocates new p, m, v;
//  * every operation is an explicitly rounded intrinsic (__fmul_rn,
//    __fadd_rn, __fdiv_rn, __fsqrt_rn), so the compiler contracts nothing
//    into an FMA and the kernel keeps the TPU kernel's expression order,
//    operation for operation, as the plain PyTorch version does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStatsThreads = 256;
constexpr int kStatsMaxBlocks = 1024;      // also the finishing block's width
constexpr long long kStatsPerBlock = 16384;  // elements per block before the cap
constexpr int kAdamThreads = 256;
constexpr int kAdamMaxBlocks = 132 * 16;

__device__ __forceinline__ void stats_one(float x, float& sq,
                                          unsigned int& nf) {
  sq = __fadd_rn(sq, __fmul_rn(x, x));
  nf += isfinite(x) ? 0u : 1u;
}

// Reduce (sq, nf) over the block into thread 0; smem holds one pair per warp.
__device__ __forceinline__ void block_reduce(float& sq, unsigned int& nf,
                                             float* smem_sq,
                                             unsigned int* smem_nf) {
  for (int off = 16; off > 0; off >>= 1) {
    sq = __fadd_rn(sq, __shfl_down_sync(0xffffffffu, sq, off));
    nf += __shfl_down_sync(0xffffffffu, nf, off);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  if (lane == 0) {
    smem_sq[warp] = sq;
    smem_nf[warp] = nf;
  }
  __syncthreads();
  if (warp == 0) {
    sq = lane < warps ? smem_sq[lane] : 0.f;
    nf = lane < warps ? smem_nf[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) {
      sq = __fadd_rn(sq, __shfl_down_sync(0xffffffffu, sq, off));
      nf += __shfl_down_sync(0xffffffffu, nf, off);
    }
  }
}

__global__ void __launch_bounds__(kStatsThreads)
detect_stats_partials(const float* __restrict__ x, long long n, int vec4,
                      float* __restrict__ part_sq,
                      unsigned int* __restrict__ part_nf) {
  __shared__ float smem_sq[32];
  __shared__ unsigned int smem_nf[32];
  float sq = 0.f;
  unsigned int nf = 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long n4 = n >> 2;
    for (long long i = t0; i < n4; i += stride) {
      const float4 v = x4[i];
      stats_one(v.x, sq, nf);
      stats_one(v.y, sq, nf);
      stats_one(v.z, sq, nf);
      stats_one(v.w, sq, nf);
    }
    done = n4 << 2;
  }
  for (long long i = done + t0; i < n; i += stride) stats_one(x[i], sq, nf);
  block_reduce(sq, nf, smem_sq, smem_nf);
  if (threadIdx.x == 0) {
    part_sq[blockIdx.x] = sq;
    part_nf[blockIdx.x] = nf;
  }
}

// One block of kStatsMaxBlocks threads: thread t holds partial t (zero past
// the block count), then the same fixed tree; out = [count, sum of squares].
__global__ void __launch_bounds__(kStatsMaxBlocks)
detect_stats_finish(const float* __restrict__ part_sq,
                    const unsigned int* __restrict__ part_nf, int blocks,
                    float* __restrict__ out) {
  __shared__ float smem_sq[32];
  __shared__ unsigned int smem_nf[32];
  const int t = threadIdx.x;
  float sq = t < blocks ? part_sq[t] : 0.f;
  unsigned int nf = t < blocks ? part_nf[t] : 0u;
  block_reduce(sq, nf, smem_sq, smem_nf);
  if (t == 0) {
    out[0] = (float)nf;
    out[1] = sq;
  }
}

__device__ __forceinline__ void adam_one(float p, float g, float m, float v,
                                         float mult, float bc1, float bc2,
                                         float lr, float b1, float omb1,
                                         float b2, float omb2, float eps,
                                         float& po, float& mo, float& vo) {
  g = __fmul_rn(g, mult);
  m = __fadd_rn(__fmul_rn(omb1, g), __fmul_rn(b1, m));
  v = __fadd_rn(__fmul_rn(omb2, __fmul_rn(g, g)), __fmul_rn(b2, v));
  const float m_hat = __fdiv_rn(m, bc1);
  const float v_hat = __fdiv_rn(v, bc2);
  const float step = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), eps));
  po = __fadd_rn(p, -__fmul_rn(lr, step));
  mo = m;
  vo = v;
}

__global__ void __launch_bounds__(kAdamThreads)
adam_update_kernel(const float* __restrict__ p, const float* __restrict__ g,
                   const float* __restrict__ m, const float* __restrict__ v,
                   const float* __restrict__ scalars, float* __restrict__ po,
                   float* __restrict__ mo, float* __restrict__ vo,
                   long long n, int vec4, float lr, float b1, float omb1,
                   float b2, float omb2, float eps) {
  const float mult = scalars[0];
  const float bc1 = scalars[1];
  const float bc2 = scalars[2];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec4) {
    const long long n4 = n >> 2;
    for (long long i = t0; i < n4; i += stride) {
      const float4 p4 = reinterpret_cast<const float4*>(p)[i];
      const float4 g4 = reinterpret_cast<const float4*>(g)[i];
      const float4 m4 = reinterpret_cast<const float4*>(m)[i];
      const float4 v4 = reinterpret_cast<const float4*>(v)[i];
      float4 a, b, c;
      adam_one(p4.x, g4.x, m4.x, v4.x, mult, bc1, bc2, lr, b1, omb1, b2,
               omb2, eps, a.x, b.x, c.x);
      adam_one(p4.y, g4.y, m4.y, v4.y, mult, bc1, bc2, lr, b1, omb1, b2,
               omb2, eps, a.y, b.y, c.y);
      adam_one(p4.z, g4.z, m4.z, v4.z, mult, bc1, bc2, lr, b1, omb1, b2,
               omb2, eps, a.z, b.z, c.z);
      adam_one(p4.w, g4.w, m4.w, v4.w, mult, bc1, bc2, lr, b1, omb1, b2,
               omb2, eps, a.w, b.w, c.w);
      reinterpret_cast<float4*>(po)[i] = a;
      reinterpret_cast<float4*>(mo)[i] = b;
      reinterpret_cast<float4*>(vo)[i] = c;
    }
    done = n4 << 2;
  }
  for (long long i = done + t0; i < n; i += stride) {
    adam_one(p[i], g[i], m[i], v[i], mult, bc1, bc2, lr, b1, omb1, b2, omb2,
             eps, po[i], mo[i], vo[i]);
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// Blocks of the first K4 launch for n elements: a function of n alone.
extern "C" int detect_stats_blocks(long long n) {
  long long b = (n + kStatsPerBlock - 1) / kStatsPerBlock;
  if (b < 1) b = 1;
  if (b > kStatsMaxBlocks) b = kStatsMaxBlocks;
  return (int)b;
}

// K4.  `scratch` holds 2 * detect_stats_blocks(n) 4-byte words (partial sums
// of squares, then partial counts); `out` 2 floats: [count, sum of squares].
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int detect_stats_f32(const void* x, long long n, void* scratch,
                                void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = detect_stats_blocks(n);
  float* part_sq = (float*)scratch;
  unsigned int* part_nf = (unsigned int*)(part_sq + blocks);
  detect_stats_partials<<<blocks, kStatsThreads, 0, s>>>(
      (const float*)x, n, aligned16(x) ? 1 : 0, part_sq, part_nf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  detect_stats_finish<<<1, kStatsMaxBlocks, 0, s>>>(part_sq, part_nf, blocks,
                                                    (float*)out);
  return (int)cudaGetLastError();
}

// K5.  p, g, m, v: n floats each; scalars: 3 floats on the card (mult, bc1,
// bc2); po, mo, vo: n floats each, written.  omb1 = 1 - b1 and omb2 = 1 - b2
// are rounded to f32 by the caller.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int adam_update_f32(const void* p, const void* g, const void* m,
                               const void* v, const void* scalars, void* po,
                               void* mo, void* vo, long long n, float lr,
                               float b1, float omb1, float b2, float omb2,
                               float eps, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  long long blocks = (n / 4 + kAdamThreads - 1) / kAdamThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kAdamMaxBlocks) blocks = kAdamMaxBlocks;
  const int vec4 = aligned16(p) && aligned16(g) && aligned16(m) &&
                   aligned16(v) && aligned16(po) && aligned16(mo) &&
                   aligned16(vo);
  adam_update_kernel<<<(int)blocks, kAdamThreads, 0, (cudaStream_t)stream>>>(
      (const float*)p, (const float*)g, (const float*)m, (const float*)v,
      (const float*)scalars, (float*)po, (float*)mo, (float*)vo, n, vec4, lr,
      b1, omb1, b2, omb2, eps);
  return (int)cudaGetLastError();
}
