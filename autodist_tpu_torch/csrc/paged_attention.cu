// Paged decode attention for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel autodist_tpu/ops/fused_kernels.py:_paged_attn_kernel
// (entry paged_attention).  That kernel walks a sequential (slot, logical
// block) grid, keeps the online-softmax state m / l / acc in VMEM scratch
// from one grid step to the next, and fetches each physical block through a
// scalar-prefetched block table.
//
// What bounds it on the H100: bytes.  Each query reads every live position's
// K and V row once, (rel_b + 1) * H * Dh * 2 * 4 bytes per slot, and does two
// multiply-adds per byte pair: far below the card's ~20 flop/byte f32 ridge.
//
// Design (simple and right first):
//  * one thread block per (slot, head): blocks run in no order on the SMs, so
//    the TPU grid's sequential block axis becomes a loop inside the block and
//    the softmax state lives in registers;
//  * the block loads its own rel[b] and its row of the block table (scalar
//    prefetch becomes "the block reads its indices"), and loops over logical
//    blocks 0 .. rel / BS only: the TPU kernel's visits past rel contribute
//    exactly zero and their table entries point at the scratch block;
//  * each visited block stages the head's [BS, Dh] K and V tiles in shared
//    memory with coalesced loads (neighbouring threads read neighbouring Dh
//    elements; rows are H * Dh apart in the pool); K rows are padded by one
//    float so the per-position dot products read shared memory without bank
//    conflicts;
//  * scores are s = q.k * (1 / sqrt(Dh)) masked to positions <= rel, the
//    running max / sum / acc[Dh] stay in f32, and the output is
//    acc / max(l, 1e-30), as in the TPU kernel;
//  * a decode batch has few (slot, head) pairs (8 x 12 = 96 blocks for 132
//    SMs), so each slot's live blocks are also split across gridDim.y blocks
//    (flash-decoding): each split writes its (m, l, acc) to a workspace the
//    wrapper allocates, and a second kernel merges the splits in order,
//    rescaling each by exp(m_split - m_max).
// Later work: warp-level scores and cp.async or TMA double buffering of the
// tiles, so each split streams at the card's rate.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // also the largest head_dim supported

// Split blockIdx.y of (slot, head) blockIdx.x: its share of the slot's live
// logical blocks.  With one split it writes the output; otherwise its running
// max and sum to part_ml [B, H, splits, 2] and its unnormalised acc to
// part_acc [B, H, splits, Dh] (an empty share writes m = -inf, l = 0).
__global__ void __launch_bounds__(kThreads)
paged_attention_f32_kernel(const float* __restrict__ q,      // [B, H, Dh]
                           const float* __restrict__ kc,     // [NB, BS, H, Dh]
                           const float* __restrict__ vc,     // [NB, BS, H, Dh]
                           const int32_t* __restrict__ bt,   // [B, MAXB]
                           const int32_t* __restrict__ rel,  // [B]
                           float* __restrict__ out,          // [B, H, Dh]
                           float* __restrict__ part_ml,
                           float* __restrict__ part_acc,
                           int H, int Dh, int BS, int MAXB, float scale) {
  extern __shared__ float smem[];
  const int ld = Dh + 1;
  float* ks = smem;            // [BS, Dh + 1]
  float* vs = ks + BS * ld;    // [BS, Dh]
  float* ps = vs + BS * Dh;    // [BS] scores, then probabilities
  float* qs = ps + BS;         // [Dh]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int r = rel[b];
  const int nblk = r < 0 ? 0 : min(r / BS + 1, MAXB);
  const int per = (nblk + gridDim.y - 1) / gridDim.y;
  const int j0 = blockIdx.y * per;
  const int j1 = min(nblk, j0 + per);
  const size_t row = (size_t)H * Dh;  // pool stride between positions

  for (int d = tid; d < Dh; d += kThreads) {
    qs[d] = q[((size_t)b * H + h) * Dh + d];
  }
  float m = -INFINITY;
  float l = 0.f;
  float acc = 0.f;  // thread tid owns output element d = tid

  for (int j = j0; j < j1; ++j) {
    const size_t base = (size_t)bt[b * MAXB + j] * BS * row + (size_t)h * Dh;
    __syncthreads();  // previous block's tiles fully consumed; qs ready
#pragma unroll 4
    for (int i = tid; i < BS * Dh; i += kThreads) {
      const int p = i / Dh;
      const int d = i - p * Dh;
      ks[p * ld + d] = kc[base + p * row + d];
      vs[p * Dh + d] = vc[base + p * row + d];
    }
    __syncthreads();
    for (int p = tid; p < BS; p += kThreads) {
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s = fmaf(qs[d], ks[p * ld + d], s);
      ps[p] = (j * BS + p <= r) ? s * scale : -INFINITY;
    }
    __syncthreads();
    float bmax = -INFINITY;
    for (int p = 0; p < BS; ++p) bmax = fmaxf(bmax, ps[p]);
    // position j * BS <= r is live, so m_new is finite
    const float m_new = fmaxf(m, bmax);
    const float corr = expf(m - m_new);
    __syncthreads();  // every thread has read the scores
    for (int p = tid; p < BS; p += kThreads) ps[p] = expf(ps[p] - m_new);
    __syncthreads();
    float bsum = 0.f;
    for (int p = 0; p < BS; ++p) bsum += ps[p];
    l = l * corr + bsum;
    if (tid < Dh) {
      float pv = 0.f;
      for (int p = 0; p < BS; ++p) pv = fmaf(ps[p], vs[p * Dh + tid], pv);
      acc = acc * corr + pv;
    }
    m = m_new;
  }
  const size_t bh = (size_t)b * H + h;
  if (gridDim.y == 1) {
    if (tid < Dh) out[bh * Dh + tid] = acc / fmaxf(l, 1e-30f);
    return;
  }
  const size_t part = bh * gridDim.y + blockIdx.y;
  if (tid < Dh) part_acc[part * Dh + tid] = acc;
  if (tid == 0) {
    part_ml[part * 2] = m;
    part_ml[part * 2 + 1] = l;
  }
}

// Merge the splits of (slot, head) blockIdx.x in order: each split's sums
// are rescaled by exp(m_split - m_max); empty splits (m = -inf) add nothing.
__global__ void paged_attention_merge(const float* __restrict__ part_ml,
                                      const float* __restrict__ part_acc,
                                      float* __restrict__ out, int Dh,
                                      int splits) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s)
    m = fmaxf(m, part_ml[(bh * splits + s) * 2]);
  float l = 0.f;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t part = bh * splits + s;
    const float ms = part_ml[part * 2];
    if (ms == -INFINITY) continue;
    const float w = expf(ms - m);
    l = fmaf(w, part_ml[part * 2 + 1], l);
    acc = fmaf(w, part_acc[part * Dh + d], acc);
  }
  out[bh * Dh + d] = acc / fmaxf(l, 1e-30f);
}

}  // namespace

extern "C" size_t paged_attention_smem_bytes(int BS, int Dh) {
  return sizeof(float) * ((size_t)BS * (Dh + 1) + (size_t)BS * Dh + BS + Dh);
}

// `splits` >= 1 blocks per (slot, head); above one, part_ml
// [B, H, splits, 2] and part_acc [B, H, splits, Dh] are f32 workspaces.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int paged_attention_f32(const void* q, const void* kc,
                                   const void* vc, const void* bt,
                                   const void* rel, void* out, void* part_ml,
                                   void* part_acc, int B, int H, int Dh,
                                   int BS, int MAXB, int splits, float scale,
                                   void* stream) {
  if (B == 0 || H == 0) return 0;
  if (splits < 1 || (splits > 1 && (part_ml == nullptr
                                    || part_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  paged_attention_f32_kernel<<<dim3(B * H, splits), kThreads,
                               paged_attention_smem_bytes(BS, Dh), s>>>(
      (const float*)q, (const float*)kc, (const float*)vc,
      (const int32_t*)bt, (const int32_t*)rel, (float*)out, (float*)part_ml,
      (float*)part_acc, H, Dh, BS, MAXB, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  paged_attention_merge<<<B * H, Dh, 0, s>>>(
      (const float*)part_ml, (const float*)part_acc, (float*)out, Dh, splits);
  return (int)cudaGetLastError();
}
