// The quantize-at-the-hop kernels of the quantized ring, for Hopper
// (sm_90a): K6 quantize, K7 hop-accumulate and K8 dequant-add, each for
// the int8 and the fp8 (e4m3) wire.
//
// Replace the TPU kernels of autodist_tpu/ops/fused_kernels.py:
//   K6 _quantize_kernel (entry fused_quantize): x -> per-256-element scale
//      grid, wire payload q, error x - q*scale, saturation count;
//   K7 _hop_kernel (entry fused_hop_accumulate): acc = q_in*s_in + chunk,
//      then K6's body on acc (the f32 partial never reaches device memory);
//   K8 _deq_add_kernel (entry fused_dequant_add): q_in*s_in + chunk.
// The quantized ring (kernel/synchronization/quant_ring.py) sends the first
// hop through K6, runs K7 at each of the d-2 middle hops and K8 on the last
// hop's receive side.
//
// What bounds them on the H100: bytes.  Per element K6 reads 4 and writes
// 1 + 4 (+ 4 bytes of scale per 256), K7 reads 1 + 4 and writes 1 + 4, K8
// reads 1 + 4 and writes 4, against ~10 f32 operations.
//
// Design:
//  * one warp per 256-element scale block, 8 elements per lane as two
//    16-byte loads (elements lane*4.. and 128 + lane*4..), the 1-byte
//    payload as two 4-byte words, so a warp touches whole 512-byte spans;
//    a ragged last block (and any pointer that is not aligned) takes
//    per-element masked loads, its padding read as 0 (never raises the
//    amax, never counts);
//  * the block's amax by a shuffle max over the lanes' finite |x| (max is
//    exact, so the order does not matter);
//  * the arithmetic of the JAX package's compiled programs, each step an
//    explicitly rounded intrinsic so the compiler changes nothing, and the
//    plain PyTorch version (ops/fused_kernels.py) gives the same bits:
//    scale = max(amax * fl(1/qmax), 1e-30) (XLA multiplies by the constant
//    reciprocal; ops/quant_scale.py), y = x / scale a true division
//    (__fdiv_rn, never a reciprocal multiply), and q * s + c and x - q * s
//    one FMA each (__fmaf_rn: XLA contracts both, one rounding);
//  * int8: round half to even (rintf), NaN -> 0, clip to +-127; fp8: clip
//    to +-448 and __nv_cvt_float_to_fp8 (round to nearest even), NaN stays
//    NaN;
//  * the saturation count (non-finite, or |round(y)| > 127 for int8,
//    |y| > 448 for fp8) goes from each warp into one unsigned long long by
//    atomicAdd: integer atomics are exact and order-free, so two runs give
//    the same count.  The entry zeroes the counter on the same stream.
#include <cuda_fp8.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;           // elements per scale block (one warp)
constexpr int kWarps = 8;             // warps (scale blocks) per CUDA block
constexpr int kThreads = 32 * kWarps;

enum Wire { kInt8 = 0, kFp8 = 1 };

template <int W> struct WireTraits;
template <> struct WireTraits<kInt8> {
  static constexpr float qmax = 127.f;
  __device__ static float decode(uint8_t b) { return (float)(int8_t)b; }
};
template <> struct WireTraits<kFp8> {
  static constexpr float qmax = 448.f;
  __device__ static float decode(uint8_t b) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(
        (__nv_fp8_storage_t)b, __NV_E4M3)));
  }
};

inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (uintptr_t)(bytes - 1)) == 0;
}

// Element j (0..7) of a lane lives at block offset half*128 + lane*4 + k.
__device__ __forceinline__ long long elem_index(long long base, int lane,
                                                int j) {
  return base + (j >> 2) * 128 + lane * 4 + (j & 3);
}

__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         long long base, long long n,
                                         int lane, bool vec, float v[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long i0 = base + h * 128 + lane * 4;
    if (vec && i0 + 3 < n) {
      const float4 f = *reinterpret_cast<const float4*>(p + i0);
      v[h * 4 + 0] = f.x;
      v[h * 4 + 1] = f.y;
      v[h * 4 + 2] = f.z;
      v[h * 4 + 3] = f.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[h * 4 + k] = i0 + k < n ? p[i0 + k] : 0.f;
    }
  }
}

__device__ __forceinline__ void store_f32(float* __restrict__ p,
                                          long long base, long long n,
                                          int lane, bool vec,
                                          const float v[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long i0 = base + h * 128 + lane * 4;
    if (vec && i0 + 3 < n) {
      *reinterpret_cast<float4*>(p + i0) =
          make_float4(v[h * 4], v[h * 4 + 1], v[h * 4 + 2], v[h * 4 + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + k < n) p[i0 + k] = v[h * 4 + k];
    }
  }
}

__device__ __forceinline__ void load_u8(const uint8_t* __restrict__ p,
                                        long long base, long long n,
                                        int lane, bool vec, uint8_t b[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long i0 = base + h * 128 + lane * 4;
    if (vec && i0 + 3 < n) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(p + i0);
#pragma unroll
      for (int k = 0; k < 4; ++k) b[h * 4 + k] = (uint8_t)(w >> (8 * k));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) b[h * 4 + k] = i0 + k < n ? p[i0 + k] : 0;
    }
  }
}

__device__ __forceinline__ void store_u8(uint8_t* __restrict__ p,
                                         long long base, long long n,
                                         int lane, bool vec,
                                         const uint8_t b[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long i0 = base + h * 128 + lane * 4;
    if (vec && i0 + 3 < n) {
      uint32_t w = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) w |= (uint32_t)b[h * 4 + k] << (8 * k);
      *reinterpret_cast<uint32_t*>(p + i0) = w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + k < n) p[i0 + k] = b[h * 4 + k];
    }
  }
}

// Quantize a warp's block `a` (8 values per lane; padding already 0):
// writes q, the block's scale (lane 0), the error, and adds the block's
// saturation count to *sat.
template <int W>
__device__ __forceinline__ void quantize_block(
    const float a[8], long long blk, long long base, long long n, int lane,
    float rq, bool vec_f, bool vec_q, uint8_t* __restrict__ q,
    float* __restrict__ scales, float* __restrict__ err,
    unsigned long long* __restrict__ sat) {
  constexpr float qmax = WireTraits<W>::qmax;
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (isfinite(a[j])) amax = fmaxf(amax, fabsf(a[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(__fmul_rn(amax, rq), 1e-30f);
  uint8_t b[8];
  float e[8];
  unsigned int cnt = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float y = __fdiv_rn(a[j], scale);
    const bool fin = isfinite(a[j]);
    float deq;
    if (W == kInt8) {
      const float r = rintf(y);
      cnt += (!fin || fabsf(r) > qmax) ? 1u : 0u;
      const float c = isnan(r) ? 0.f : fminf(fmaxf(r, -qmax), qmax);
      b[j] = (uint8_t)(int8_t)(int)c;
      deq = c;
    } else {
      cnt += (!fin || fabsf(y) > qmax) ? 1u : 0u;
      const float c = isnan(y) ? y : fminf(fmaxf(y, -qmax), qmax);
      b[j] = (uint8_t)__nv_cvt_float_to_fp8(c, __NV_SATFINITE, __NV_E4M3);
      deq = WireTraits<W>::decode(b[j]);
    }
    e[j] = __fmaf_rn(-deq, scale, a[j]);
  }
  store_u8(q, base, n, lane, vec_q, b);
  store_f32(err, base, n, lane, vec_f, e);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if (lane == 0) {
    scales[blk] = scale;
    if (cnt) atomicAdd(sat, (unsigned long long)cnt);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, long long n, long long nb,
                float rq, int vec_f, int vec_q, uint8_t* __restrict__ q,
                float* __restrict__ scales, float* __restrict__ err,
                unsigned long long* __restrict__ sat) {
  const int lane = threadIdx.x & 31;
  const long long blk = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk >= nb) return;
  const long long base = blk * kBlock;
  float a[8];
  load_f32(x, base, n, lane, vec_f, a);
  quantize_block<W>(a, blk, base, n, lane, rq, vec_f, vec_q, q, scales, err,
                    sat);
}

// acc = q_in * s_in + chunk for a lane's 8 elements (padding stays 0).
template <int W>
__device__ __forceinline__ void dequant_add(
    const uint8_t* __restrict__ q_in, const float* __restrict__ s_in,
    const float* __restrict__ chunk, long long blk, long long base,
    long long n, int lane, bool vec_f, bool vec_q, float acc[8]) {
  uint8_t b[8];
  load_u8(q_in, base, n, lane, vec_q, b);
  load_f32(chunk, base, n, lane, vec_f, acc);
  const float s = s_in[blk];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (elem_index(base, lane, j) < n)
      acc[j] = __fmaf_rn(WireTraits<W>::decode(b[j]), s, acc[j]);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
hop_kernel(const uint8_t* __restrict__ q_in, const float* __restrict__ s_in,
           const float* __restrict__ chunk, long long n, long long nb,
           float rq, int vec_f, int vec_q, uint8_t* __restrict__ q,
           float* __restrict__ scales, float* __restrict__ err,
           unsigned long long* __restrict__ sat) {
  const int lane = threadIdx.x & 31;
  const long long blk = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk >= nb) return;
  const long long base = blk * kBlock;
  float acc[8];
  dequant_add<W>(q_in, s_in, chunk, blk, base, n, lane, vec_f, vec_q, acc);
  quantize_block<W>(acc, blk, base, n, lane, rq, vec_f, vec_q, q, scales,
                    err, sat);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
deq_add_kernel(const uint8_t* __restrict__ q_in,
               const float* __restrict__ s_in,
               const float* __restrict__ chunk, long long n, long long nb,
               int vec_f, int vec_q, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long blk = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk >= nb) return;
  const long long base = blk * kBlock;
  float acc[8];
  dequant_add<W>(q_in, s_in, chunk, blk, base, n, lane, vec_f, vec_q, acc);
  store_f32(out, base, n, lane, vec_f, acc);
}

inline long long grid_for(long long nb) { return (nb + kWarps - 1) / kWarps; }

}  // namespace

// K6.  x: n floats; q: n wire bytes, scales: ceil(n/256) floats, err: n
// floats, sat: one unsigned long long (zeroed here), all written.  wire 0 is
// int8, 1 fp8 e4m3; rq = fl(1/qmax).  Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int quant_hop_quantize(const void* x, long long n, int wire,
                                  float rq, void* q, void* scales, void* err,
                                  void* sat, void* stream) {
  if (n < 0 || (wire != kInt8 && wire != kFp8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(sat, 0, sizeof(unsigned long long), s);
  if (e != cudaSuccess || n == 0) return (int)e;
  const long long nb = (n + kBlock - 1) / kBlock;
  const int vf = aligned(x, 16) && aligned(err, 16);
  const int vq = aligned(q, 4);
  auto k = wire == kInt8 ? quantize_kernel<kInt8> : quantize_kernel<kFp8>;
  k<<<(unsigned)grid_for(nb), kThreads, 0, s>>>(
      (const float*)x, n, nb, rq, vf, vq, (uint8_t*)q, (float*)scales,
      (float*)err, (unsigned long long*)sat);
  return (int)cudaGetLastError();
}

// K7.  q_in: n wire bytes, s_in: ceil(n/256) floats, chunk: n floats; the
// outputs as K6's.
extern "C" int quant_hop_accumulate(const void* q_in, const void* s_in,
                                    const void* chunk, long long n, int wire,
                                    float rq, void* q, void* scales,
                                    void* err, void* sat, void* stream) {
  if (n < 0 || (wire != kInt8 && wire != kFp8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(sat, 0, sizeof(unsigned long long), s);
  if (e != cudaSuccess || n == 0) return (int)e;
  const long long nb = (n + kBlock - 1) / kBlock;
  const int vf = aligned(chunk, 16) && aligned(err, 16);
  const int vq = aligned(q_in, 4) && aligned(q, 4);
  auto k = wire == kInt8 ? hop_kernel<kInt8> : hop_kernel<kFp8>;
  k<<<(unsigned)grid_for(nb), kThreads, 0, s>>>(
      (const uint8_t*)q_in, (const float*)s_in, (const float*)chunk, n, nb,
      rq, vf, vq, (uint8_t*)q, (float*)scales, (float*)err,
      (unsigned long long*)sat);
  return (int)cudaGetLastError();
}

// K8.  Inputs as K7's; out: n floats, written.
extern "C" int quant_hop_dequant_add(const void* q_in, const void* s_in,
                                     const void* chunk, long long n, int wire,
                                     void* out, void* stream) {
  if (n < 0 || (wire != kInt8 && wire != kFp8))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long nb = (n + kBlock - 1) / kBlock;
  const int vf = aligned(chunk, 16) && aligned(out, 16);
  const int vq = aligned(q_in, 4);
  auto k = wire == kInt8 ? deq_add_kernel<kInt8> : deq_add_kernel<kFp8>;
  k<<<(unsigned)grid_for(nb), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)q_in, (const float*)s_in, (const float*)chunk, n, nb,
      vf, vq, (float*)out);
  return (int)cudaGetLastError();
}
