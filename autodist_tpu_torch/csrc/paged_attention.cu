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
// A head's K (or V) row is Dh floats, H * Dh floats from the next
// position's.
//
// Design: one launch, one cluster of `splits` blocks per (slot, head).
//  * the slot's live positions 0 .. min(rel, MAXB * BS - 1) are cut into
//    tiles of 32; a cluster's blocks (gridDim.y) take contiguous runs of
//    tiles, and the 4 warps of a block take 8 positions of each tile;
//  * each warp streams its own rows: K and V of its 8 positions go through
//    a kStages-deep cp.async pipeline into the warp's own shared memory
//    (16-byte copies, or 4-byte ones where Dh % 4 != 0; positions past rel
//    and the row's padding are zero-filled), so a tile needs only
//    __syncwarp, never a block barrier.  Each block loads its own rel and
//    table entries (the TPU kernel's scalar prefetch);
//  * scores warp-wide: a quad of lanes per position, each lane a float4
//    of every fourth 16-byte chunk of the K row against q (held in
//    registers), then two xor shuffles.  K rows are padded to a stride of
//    16 (mod 32) floats so the quad reads of two positions hit 32 banks;
//  * each warp keeps its own online softmax (m, l, and acc for the output
//    elements lane, lane + 32, ..): the tile's max and sum come from three
//    xor shuffles across the 8 positions, P.V from one shuffle of each
//    position's weight and one read of its V row per lane;
//  * the merge of the (block, warp) states runs in the same launch: each
//    block writes its warps' (m, l, acc) to its shared memory, and after a
//    cluster barrier rank 0 reads every rank's through distributed shared
//    memory in rank and warp order, which makes it deterministic, and
//    writes acc / max(l, 1e-30).  A state with no live position (m = -inf)
//    adds nothing.
//  * scores are q.k * (1 / sqrt(Dh)) masked to positions <= rel, as in the
//    TPU kernel; exp is expf.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;                   // positions per warp per tile
constexpr int kTile = kWarps * kRows;      // positions per tile
constexpr int kStages = 3;                 // cp.async pipeline depth
constexpr int kMaxChunks = 32;             // 16-byte chunks of Dh <= 128
constexpr int kMaxDevices = 16;            // cards whose opt-in is cached

__host__ __device__ constexpr int round4(int d) { return (d + 3) / 4 * 4; }
// K row stride: the padded row, 16 (mod 32) floats.
__host__ __device__ constexpr int ld_k(int dh) {
  return round4(dh) + ((16 - round4(dh)) % 32 + 32) % 32;
}
__host__ __device__ constexpr int warp_floats(int dh) {
  return kStages * kRows * (ld_k(dh) + round4(dh));
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kStages - 1) : "memory");
}

// The warp's kRows positions of tile `tile` into k_dst [kRows][ldk] and
// v_dst [kRows][d4]; positions past `last` and columns past Dh are zeros.
template <bool VEC>
__device__ __forceinline__ void stage_tile(float* k_dst, float* v_dst,
                                           const float* kc, const float* vc,
                                           const int32_t* table, int tile,
                                           int last, int h, int H, int Dh,
                                           int BS, int lane) {
  const int d4 = round4(Dh), ldk = ld_k(Dh);
  const int p0 = tile * kTile + (threadIdx.x / 32) * kRows;
  const int per_row = VEC ? d4 / 4 : d4;       // copies per row
  for (int i = lane; i < kRows * per_row; i += 32) {
    const int r = i / per_row, c = i - r * per_row;
    const int d = VEC ? 4 * c : c;
    const int pos = p0 + r;
    const bool live = pos <= last && d < Dh;
    size_t off = 0;
    if (live) {
      off = (((size_t)table[pos / BS] * BS + pos % BS) * H + h) * Dh + d;
    }
    cp_async(k_dst + r * ldk + d, kc + off, live, VEC ? 16 : 4);
    cp_async(v_dst + r * d4 + d, vc + off, live, VEC ? 16 : 4);
  }
}

// Block (blockIdx.y = cluster rank) of (slot, head) blockIdx.x.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
paged_attention_f32_kernel(const float* __restrict__ q,      // [B, H, Dh]
                           const float* __restrict__ kc,     // [NB, BS, H, Dh]
                           const float* __restrict__ vc,     // [NB, BS, H, Dh]
                           const int32_t* __restrict__ bt,   // [B, MAXB]
                           const int32_t* __restrict__ rel,  // [B]
                           float* __restrict__ out,          // [B, H, Dh]
                           int H, int Dh, int BS, int MAXB, float scale) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int splits = (int)cluster.num_blocks();
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pp = lane / 4, part = lane % 4;   // scores: position, quarter
  const int d4 = round4(Dh), ldk = ld_k(Dh), nch = d4 / 4;
  const int last = min(rel[b], MAXB * BS - 1);
  const int ntiles = last < 0 ? 0 : last / kTile + 1;
  const int per = (ntiles + splits - 1) / splits;
  const int t0 = min(ntiles, rank * per);
  const int t1 = min(ntiles, t0 + per);
  const int32_t* table = bt + (size_t)b * MAXB;
  float* wk = smem + warp * warp_floats(Dh);   // [kStages][kRows][ldk]
  float* wv = wk + kStages * kRows * ldk;       // [kStages][kRows][d4]

  for (int s = 0; s < kStages - 1; ++s) {
    if (t0 + s < t1)
      stage_tile<VEC>(wk + s * kRows * ldk, wv + s * kRows * d4, kc, vc,
                      table, t0 + s, last, h, H, Dh, BS, lane);
    cp_async_commit();
  }
  // q chunks part, part + 4, .. of this (slot, head), zero past Dh
  const float* qh = q + ((size_t)b * H + h) * Dh;
  float4 qv[kMaxChunks / 4];
#pragma unroll
  for (int i = 0; i < kMaxChunks / 4; ++i) {
    const int d = 4 * (part + 4 * i);
    float e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) e[u] = d + u < Dh ? qh[d + u] : 0.f;
    qv[i] = make_float4(e[0], e[1], e[2], e[3]);
  }
  float m = -INFINITY, l = 0.f;
  float acc[kMaxChunks / 8];        // output elements lane + 32 v
#pragma unroll
  for (int v = 0; v < kMaxChunks / 8; ++v) acc[v] = 0.f;

  for (int it = t0; it < t1; ++it) {
    const int nxt = it + kStages - 1;
    if (nxt < t1) {
      const int st = (nxt - t0) % kStages;
      stage_tile<VEC>(wk + st * kRows * ldk, wv + st * kRows * d4, kc, vc,
                      table, nxt, last, h, H, Dh, BS, lane);
    }
    cp_async_commit();
    cp_async_wait_stages();     // tile it, this lane's copies
    __syncwarp();               // the warp's copies
    const int st = (it - t0) % kStages;
    const float* ks = wk + st * kRows * ldk;
    const float* vs = wv + st * kRows * d4;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxChunks / 4; ++i) {
      const int c = part + 4 * i;
      if (c < nch) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + pp * ldk
                                                           + 4 * c);
        s = fmaf(qv[i].x, kv.x, s);
        s = fmaf(qv[i].y, kv.y, s);
        s = fmaf(qv[i].z, kv.z, s);
        s = fmaf(qv[i].w, kv.w, s);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const int pos = it * kTile + warp * kRows + pp;
    s = pos <= last ? s * scale : -INFINITY;
    float tmax = s;
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 8));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 16));
    if (tmax != -INFINITY) {          // warp-uniform: some position live
      const float m_new = fmaxf(m, tmax);
      const float corr = expf(m - m_new);   // 0 while m = -inf
      const float pw = pos <= last ? expf(s - m_new) : 0.f;
      float psum = pw;
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      psum += __shfl_xor_sync(0xffffffffu, psum, 8);
      psum += __shfl_xor_sync(0xffffffffu, psum, 16);
      l = l * corr + psum;
#pragma unroll
      for (int v = 0; v < kMaxChunks / 8; ++v) acc[v] *= corr;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float w = __shfl_sync(0xffffffffu, pw, 4 * r);
#pragma unroll
        for (int v = 0; v < kMaxChunks / 8; ++v) {
          const int d = lane + 32 * v;
          if (d < d4) acc[v] = fmaf(w, vs[r * d4 + d], acc[v]);
        }
      }
      m = m_new;
    }
    __syncwarp();               // the stage is read before it is refilled
  }

  // Every warp's state into this block's shared memory: [warp][2 + d4].
  __syncthreads();              // every warp is done with its stages
  float* state = smem + warp * (2 + d4);
  if (lane == 0) {
    state[0] = m;
    state[1] = l;
  }
#pragma unroll
  for (int v = 0; v < kMaxChunks / 8; ++v) {
    const int d = lane + 32 * v;
    if (d < d4) state[2 + d] = acc[v];
  }
  cluster.sync();
  if (rank == 0) {
    float mx = -INFINITY;
    for (int r = 0; r < splits; ++r) {
      const float* st = cluster.map_shared_rank(smem, r);
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, st[w * (2 + d4)]);
    }
    for (int d = threadIdx.x; d < Dh; d += kThreads) {
      float lsum = 0.f, o = 0.f;
      for (int r = 0; r < splits; ++r) {
        const float* st = cluster.map_shared_rank(smem, r);
        for (int w = 0; w < kWarps; ++w) {
          const float* sw = st + w * (2 + d4);
          if (sw[0] == -INFINITY) continue;
          const float e = expf(sw[0] - mx);
          lsum = fmaf(e, sw[1], lsum);
          o = fmaf(e, sw[2 + d], o);
        }
      }
      out[((size_t)b * H + h) * Dh + d] = o / fmaxf(lsum, 1e-30f);
    }
  }
  cluster.sync();               // no block leaves while rank 0 reads it
}

// The stages of every warp; the merge's [warp][2 + d4] states reuse them.
size_t smem_bytes(int Dh) {
  return sizeof(float) * kWarps * warp_floats(Dh);
}

}  // namespace

// `splits` (1..8) blocks per (slot, head), launched as one cluster.
// Launches once on `stream`, allocates nothing, and returns the launch's
// error (0 = launched).
extern "C" int paged_attention_f32(const void* q, const void* kc,
                                   const void* vc, const void* bt,
                                   const void* rel, void* out, int B, int H,
                                   int Dh, int BS, int MAXB, int splits,
                                   float scale, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (splits < 1 || splits > 8 || Dh < 1 || Dh > 4 * kMaxChunks)
    return (int)cudaErrorInvalidValue;
  const bool vec = Dh % 4 == 0 && (uintptr_t)q % 16 == 0
                   && (uintptr_t)kc % 16 == 0 && (uintptr_t)vc % 16 == 0;
  const size_t smem = smem_bytes(Dh);
  auto kernel = vec ? paged_attention_f32_kernel<true>
                    : paged_attention_f32_kernel<false>;
  // the limit is raised once per variant, card and size
  static size_t raised[2][kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  size_t* done = dev < kMaxDevices ? &raised[vec][dev] : nullptr;
  if (smem > 48 * 1024 && (done == nullptr || *done < smem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (done != nullptr) *done = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, (const float*)q,
                                 (const float*)kc, (const float*)vc,
                                 (const int32_t*)bt, (const int32_t*)rel,
                                 (float*)out, H, Dh, BS, MAXB, scale);
}
