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
// What bounds them on the H100: operations.  At the training shape (B 8,
// T 1024, H 12, D 64, causal) the forward does two T x T x D products per
// (batch, head), ~12.9 GFLOP after causal halving, against ~100 MB of
// inputs and outputs: ~130 flop per byte, far above the f32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20 flop per byte).  The backward does three
// (dQ) and four (dK/dV) such products.
//
// Design (simple and right first; f32 on CUDA cores, no tensor cores):
//  * q, k, v, o, dO are read and written in the public [B, T, H, D] layout
//    through strides (rows H * D apart); lse and delta are [B, H, T].  No
//    transposes and no padding: the ragged tail (T not a multiple of the
//    tile) is masked inside the kernels;
//  * a block owns 64 rows (q rows for K1/K2, key rows for K3), four threads
//    per row, each holding a quarter of the row's D elements in registers
//    (interleaved 8- or 16-byte vectors, so the four threads of a row read
//    neighbouring shared-memory banks).  A row's dot product is the four
//    partial sums added with two xor shuffles, which leaves the same value
//    in all four threads;
//  * the other operand streams through shared memory in tiles of 64 rows:
//    K and V for K1/K2, pre-scaled Q, dO, lse and delta for K3 (at most
//    32.5 KB at D = 64, under the 48 KB default);
//  * K1 keeps m, l and acc in registers in f32 and, per tile, all the
//    tile's scores; causal blocks stop at the tile holding their last row's
//    diagonal (the TPU kernel's `upper`); o = acc / max(l, 1e-30) and
//    lse = m + log(max(l, 1e-30));
//  * masked scores are the finite sentinel -1e30, never -inf, so a row whose
//    tile is fully masked stays NaN-free (the TPU kernel's _NEG_INF);
//  * K2 recomputes P = exp(S - lse) per q tile and takes delta = rowsum(dO o)
//    - dlse as an input (the wrapper computes it); dQ = scale * sum dS K;
//  * K3 owns a key tile and loops over q tiles from the causal lower bound
//    (its own tile index: tiles are square), keeping dK and dV in registers.  Q is
//    pre-scaled, so dS^T Q already carries 1/sqrt(D).  No atomics: K2 and K3
//    sum in a fixed order, and two backward runs give identical bits.
// Later work: tensor cores (mma / wgmma on tf32 or bf16 tiles), cp.async or
// TMA double buffering, and a register-tiled S so each shared-memory load
// feeds more than one multiply-add.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                 // rows a block owns and rows of
                                          // each streamed tile
constexpr int kTpr = 4;                   // threads per owned row
constexpr int kThreads = kRows * kTpr;    // 256
constexpr float kNegInf = -1e30f;         // finite masked-score sentinel

template <int D>
struct Cfg {
  static constexpr int kVec = (D / kTpr) >= 4 ? 4 : 2;  // floats per load
  static constexpr int kNv = D / (kTpr * kVec);         // loads per row part
  static constexpr int kNe = kNv * kVec;                // elements per part
};

// Element offset (within a row of D) of vector x of thread part `part`.
template <int D>
__device__ __forceinline__ int vec_off(int part, int x) {
  return (part + kTpr * x) * Cfg<D>::kVec;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  }
}

// This thread's part of a D-element row (row pointer `p`), into regs[kNe].
template <int D>
__device__ __forceinline__ void load_part(const float* p, int part,
                                          float* regs) {
  constexpr int V = Cfg<D>::kVec;
#pragma unroll
  for (int x = 0; x < Cfg<D>::kNv; ++x)
    load_vec<V>(p + vec_off<D>(part, x), regs + x * V);
}

template <int D>
__device__ __forceinline__ void store_part(float* p, int part,
                                           const float* regs) {
  constexpr int V = Cfg<D>::kVec;
#pragma unroll
  for (int x = 0; x < Cfg<D>::kNv; ++x)
    store_vec<V>(p + vec_off<D>(part, x), regs + x * V);
}

// Sum over the four threads of a row (adjacent lanes); every one of the
// four gets the same bits, (a + b) + (c + d).
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Stage rows r0 .. r0 + ROWS of one (batch, head) into dst [ROWS, D] with
// 16-byte loads, times `mul`; rows at or beyond T are zero.  `src` points at
// element (b, 0, h, 0); rows are `stride` floats apart.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t stride, int r0, int T,
                                          float mul) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = i - r * kPerRow;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) {
      val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * stride
                                             + c * 4);
      val.x *= mul; val.y *= mul; val.z *= mul; val.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * D + c * 4) = val;
  }
}

// K1: one block per (q tile, head, batch).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int T, int H, float scale) {
  constexpr int BN = kRows;
  constexpr int NE = Cfg<D>::kNe;
  __shared__ __align__(16) float ks[BN * D];
  __shared__ __align__(16) float vs[BN * D];

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = threadIdx.x / kTpr;
  const int part = threadIdx.x % kTpr;
  const int qi = qt * kRows + row;
  const bool live = qi < T;
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * T * H + h) * D;

  float qr[NE], acc[NE];
  if (live) {
    load_part<D>(q + base + qi * stride, part, qr);
  } else {
#pragma unroll
    for (int e = 0; e < NE; ++e) qr[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    qr[e] *= scale;
    acc[e] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const int nkt = (T + BN - 1) / BN;
  const int upper = CAUSAL ? qt + 1 : nkt;  // the tile of the diagonal
  for (int kt = 0; kt < upper; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile is fully consumed
    load_tile<D, BN>(ks, k + base, stride, k0, T, 1.f);
    load_tile<D, BN>(vs, v + base, stride, k0, T, 1.f);
    __syncthreads();

    float s[BN];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float kr[NE];
      load_part<D>(ks + j * D, part, kr);
      float p = 0.f;
#pragma unroll
      for (int e = 0; e < NE; ++e) p = fmaf(qr[e], kr[e], p);
      const float sj = row_sum(p);
      const int kj = k0 + j;
      const bool ok = kj < T && (!CAUSAL || kj <= qi);
      s[j] = ok ? sj : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[e] *= corr;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      float vr[NE];
      load_part<D>(vs + j * D, part, vr);
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[e] = fmaf(p, vr[e], acc[e]);
    }
    l = l * corr + psum;
    m = m_new;
  }
  if (!live) return;
  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = acc[e] / lc;
  store_part<D>(o + base + qi * stride, part, acc);
  if (part == 0) lse[((size_t)b * H + h) * T + qi] = m + logf(lc);
}

// K2: one block per (q tile, head, batch).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int T, int H, float scale) {
  constexpr int BN = kRows;
  constexpr int NE = Cfg<D>::kNe;
  __shared__ __align__(16) float ks[BN * D];
  __shared__ __align__(16) float vs[BN * D];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = threadIdx.x / kTpr;
  const int part = threadIdx.x % kTpr;
  const int qi = qt * kRows + row;
  const bool live = qi < T;
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * T * H + h) * D;
  const size_t bh = (size_t)b * H + h;

  float qr[NE], dor[NE], dqa[NE];
  if (live) {
    load_part<D>(q + base + qi * stride, part, qr);
    load_part<D>(dout + base + qi * stride, part, dor);
  } else {
#pragma unroll
    for (int e = 0; e < NE; ++e) qr[e] = dor[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    qr[e] *= scale;
    dqa[e] = 0.f;
  }
  const float lse_i = live ? lse[bh * T + qi] : 0.f;
  const float delta_i = live ? delta[bh * T + qi] : 0.f;

  const int nkt = (T + BN - 1) / BN;
  const int upper = CAUSAL ? qt + 1 : nkt;  // the tile of the diagonal
  for (int kt = 0; kt < upper; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<D, BN>(ks, k + base, stride, k0, T, 1.f);
    load_tile<D, BN>(vs, v + base, stride, k0, T, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float kr[NE], vr[NE];
      load_part<D>(ks + j * D, part, kr);
      load_part<D>(vs + j * D, part, vr);
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        ps = fmaf(qr[e], kr[e], ps);
        pd = fmaf(dor[e], vr[e], pd);
      }
      const float s = row_sum(ps);
      const float dp = row_sum(pd);
      const int kj = k0 + j;
      const bool ok = kj < T && (!CAUSAL || kj <= qi);
      const float p = ok ? expf(s - lse_i) : 0.f;
      const float ds = p * (dp - delta_i);
#pragma unroll
      for (int e = 0; e < NE; ++e) dqa[e] = fmaf(ds, kr[e], dqa[e]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int e = 0; e < NE; ++e) dqa[e] *= scale;
  store_part<D>(dq + base + qi * stride, part, dqa);
}

// K3: one block per (key tile, head, batch).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int T, int H, float scale) {
  constexpr int BN = kRows;
  constexpr int NE = Cfg<D>::kNe;
  __shared__ __align__(16) float qs[BN * D];
  __shared__ __align__(16) float dos[BN * D];
  __shared__ float ls[BN];
  __shared__ float dls[BN];

  const int kt = blockIdx.x;  // early key tiles see the most q rows
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = threadIdx.x / kTpr;
  const int part = threadIdx.x % kTpr;
  const int kj = kt * kRows + row;
  const bool live = kj < T;
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * T * H + h) * D;
  const size_t bh = (size_t)b * H + h;

  float kr[NE], vr[NE], dka[NE], dva[NE];
  if (live) {
    load_part<D>(k + base + kj * stride, part, kr);
    load_part<D>(v + base + kj * stride, part, vr);
  } else {
#pragma unroll
    for (int e = 0; e < NE; ++e) kr[e] = vr[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < NE; ++e) dka[e] = dva[e] = 0.f;

  const int nqt = (T + BN - 1) / BN;
  const int lower = CAUSAL ? kt : 0;  // the tile of the diagonal
  for (int qb = lower; qb < nqt; ++qb) {
    const int q0 = qb * BN;
    __syncthreads();
    load_tile<D, BN>(qs, q + base, stride, q0, T, scale);
    load_tile<D, BN>(dos, dout + base, stride, q0, T, 1.f);
    for (int i = threadIdx.x; i < BN; i += kThreads) {
      const bool in = q0 + i < T;
      ls[i] = in ? lse[bh * T + q0 + i] : 0.f;
      dls[i] = in ? delta[bh * T + q0 + i] : 0.f;
    }
    __syncthreads();
    const int nrows = min(BN, T - q0);
#pragma unroll 4
    for (int i = 0; i < nrows; ++i) {
      float qrow[NE], drow[NE];
      load_part<D>(qs + i * D, part, qrow);
      load_part<D>(dos + i * D, part, drow);
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        ps = fmaf(qrow[e], kr[e], ps);
        pd = fmaf(drow[e], vr[e], pd);
      }
      const float s = row_sum(ps);
      const float dp = row_sum(pd);
      const bool ok = live && (!CAUSAL || kj <= q0 + i);
      const float p = ok ? expf(s - ls[i]) : 0.f;
      const float ds = p * (dp - dls[i]);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        dva[e] = fmaf(p, drow[e], dva[e]);
        dka[e] = fmaf(ds, qrow[e], dka[e]);
      }
    }
  }
  if (!live) return;
  store_part<D>(dk + base + kj * stride, part, dka);
  store_part<D>(dv + base + kj * stride, part, dva);
}

dim3 grid_for(int B, int T, int H) {
  return dim3((T + kRows - 1) / kRows, H, B);
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *o, *lse_out, *dq, *dk, *dv;
  int B, T, H;
  float scale;
  cudaStream_t stream;
};

template <int D, bool C>
void launch_fwd(const Args& a) {
  flash_fwd_kernel<D, C><<<grid_for(a.B, a.T, a.H), kThreads, 0, a.stream>>>(
      a.q, a.k, a.v, a.o, a.lse_out, a.T, a.H, a.scale);
}

template <int D, bool C>
void launch_dq(const Args& a) {
  flash_dq_kernel<D, C><<<grid_for(a.B, a.T, a.H), kThreads, 0, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.T, a.H, a.scale);
}

template <int D, bool C>
void launch_dkv(const Args& a) {
  flash_dkv_kernel<D, C><<<grid_for(a.B, a.T, a.H), kThreads, 0, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.T, a.H, a.scale);
}

// Runs LAUNCH<D, causal>(a) for the supported head dims; false otherwise.
template <template <int, bool> class L>
bool dispatch(int D, bool causal, const Args& a) {
  switch (D) {
    case 8: causal ? L<8, true>::run(a) : L<8, false>::run(a); return true;
    case 16: causal ? L<16, true>::run(a) : L<16, false>::run(a); return true;
    case 64: causal ? L<64, true>::run(a) : L<64, false>::run(a); return true;
    default: return false;
  }
}

template <int D, bool C> struct Fwd { static void run(const Args& a) { launch_fwd<D, C>(a); } };
template <int D, bool C> struct Dq { static void run(const Args& a) { launch_dq<D, C>(a); } };
template <int D, bool C> struct Dkv { static void run(const Args& a) { launch_dkv<D, C>(a); } };

int finish(bool ok) {
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// All tensors contiguous f32 on the card, 16-byte aligned: q, k, v, o, dout,
// dq, dk, dv [B, T, H, D]; lse and delta [B, H, T].  D is one of 8, 16,
// 64.  Each entry launches one kernel on `stream`, allocates nothing,
// and returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int T, int H, int D,
                             int causal, float scale, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  Args a{};
  a.q = (const float*)q; a.k = (const float*)k; a.v = (const float*)v;
  a.o = (float*)o; a.lse_out = (float*)lse;
  a.B = B; a.T = T; a.H = H; a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return finish(dispatch<Fwd>(D, causal != 0, a));
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
  return finish(dispatch<Dq>(D, causal != 0, a));
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
  return finish(dispatch<Dkv>(D, causal != 0, a));
}
