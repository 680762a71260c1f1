// Flash-decode GQA attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/decode_attention.py
// decode_attention_pallas (wrapper ops.py decode_attention): one query token
// for each of the G query heads of a KV head against the KV cache,
// softmax(q . k_j * D^-0.5) applied to V.  Cache positions j >= lengths[b] are
// masked with the finite value -1e30 (not -inf), so a length of 0 gives the
// uniform mean of V over the S cache rows, as on the TPU, and never NaN.
//
// Layouts (row-major, contiguous): q, out (B, KV, G, D); k, v (B, S, KV, D);
// lengths (B,) int32.  D in {16, 32, 64, 80, 128, 256}, G in 1..8.
//
// Two kernels, split by the storage type:
//
// bf16 (the served type): the cache rows of one (batch row, KV head) are split
// over a thread-block cluster of `split` blocks (8, halved while B KV split
// exceeds four blocks per SM or a block would get fewer than 16 rows), launched
// with cudaLaunchKernelEx and a cluster-dimension attribute: one launch, no
// scratch tensor, no atomics.  Each block takes a contiguous range of rows.
// Where lengths[b] > 0 only rows < lengths[b] are read (a masked row weighs 0);
// where it is 0 every row is read with the score -1e30, so the result is the
// mean of V; a block whose range is empty holds m = -inf, l = 0.  A row is
// read by D / 8 lanes with 16-byte loads (rounded up to a power of two: 8
// lanes at D = 64, so a warp load covers 4 rows; 16 at D = 80, of which 10
// load; a whole warp at D = 256, so a block has 4 streams and its partial
// accumulators, 4 x G x D f32, stay within the 48 KB of static shared
// memory at G = 8), the dot product of each of the G queries is reduced over the row's
// lanes with xor shuffles, and each lane keeps 8 output columns x G
// accumulators.  Each group of lanes is one online-softmax stream that
// loads U rows (4, or 2 at G > 4) before it uses any, so several rows are in
// flight.  The streams of a block combine in shared memory; after
// cluster.sync() the blocks share out the G D outputs (block r takes the
// runs r, r + split, ... of 128) and each reads every block's (m, l, acc)
// for its outputs through distributed shared memory
// (cluster.map_shared_rank), combines them in rank order and writes out (at
// G D = 2048, gemma-2b's G 8 and D 256, one combining block would read 16
// outputs x 8 blocks a thread); a second cluster.sync() keeps each block's
// shared memory alive until the others have read it.  Exponentials are base 2 on scores scaled by
// D^-0.5 log2(e), the same softmax.
//
// f32 (full-width parity and the tests): the first port's kernel, unchanged.
// One block per (KV head, batch row) holding the G query rows in shared
// memory; its 4 warps stride over S in chunks of 32 cache rows: a lane
// scores its own row against all G queries, the warp updates each query's
// online softmax (m, l) with warp reductions and accumulates P.V with each
// lane owning ceil(D / 32) output columns; the warps' partial (m, l, acc)
// are then combined in shared memory.
//
// What bounds it on the H100: the bytes of K and V read (the G query heads
// of a KV head share one pass over its rows, so the arithmetic intensity is
// about G).  At the served shapes those bytes are a few MB at most, so the
// latency of one block's chain of loads and of the launch bound the bf16
// kernel; splitting each (batch row, KV head) over a cluster gives the card
// 96 blocks at smollm-135m's shape where the f32 kernel has 12, and reading
// only the valid rows cuts the bytes to what the bound counts.
// chip_smoke.py computes the least time from the bytes and measures the
// kernel beside it (PERF.md keeps the numbers).
#include <cmath>
#include <type_traits>

#include <cooperative_groups.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxG = 8;

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        T* __restrict__ out, int S, int KV, int G, float scale) {
  constexpr int DPL = (D + 31) / 32;         // output columns per lane
  __shared__ float q_s[kMaxG * D];
  __shared__ float p_s[kWarps][kMaxG][32];
  __shared__ float part_m[kWarps][kMaxG];
  __shared__ float part_l[kWarps][kMaxG];
  __shared__ float part_acc[kWarps][kMaxG][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = lengths[b];
  const int64_t head = (static_cast<int64_t>(b) * KV + kvh) * G * D;

  for (int i = tid; i < G * D; i += blockDim.x) q_s[i] = to_f32(q[head + i]) * scale;
  __syncthreads();

  float m[kMaxG], l[kMaxG], acc[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  const int64_t row_stride = static_cast<int64_t>(KV) * D;
  const int64_t base = (static_cast<int64_t>(b) * S * KV + kvh) * D;
  const T* kb = k + base;
  const T* vb = v + base;
  for (int c0 = warp * 32; c0 < S; c0 += kWarps * 32) {
    const int j = c0 + lane;
    const bool exists = j < S;               // a ragged last chunk
    const bool valid = j < len;
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    if (exists) {
      const T* kr = kb + j * row_stride;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8) {
        float x[8];
        load8(kr + d0, x);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
#pragma unroll
            for (int t = 0; t < 8; ++t) s[g] = fmaf(q_s[g * D + d0 + t], x[t], s[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float sg = valid ? s[g] : kNegInf;
        const float m_new = fmaxf(m[g], warp_max(exists ? sg : neg_inf()));
        const float p = exists ? expf(sg - m_new) : 0.f;
        const float alpha = expf(m[g] - m_new);
        l[g] = l[g] * alpha + warp_sum(p);
        m[g] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
        p_s[warp][g][lane] = p;
      }
    }
    __syncwarp();
    const int n = min(32, S - c0);
    for (int jj = 0; jj < n; ++jj) {
      const T* vr = vb + (c0 + jj) * row_stride;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float vd = to_f32(vr[d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) acc[g][i] = fmaf(p_s[warp][g][jj], vd, acc[g][i]);
          }
        }
      }
    }
    __syncwarp();                            // p_s is rewritten by the next chunk
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      if (lane == 0) {
        part_m[warp][g] = m[g];
        part_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) part_acc[warp][g][d] = acc[g][i];
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i % D;
    float mx = part_m[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, part_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(part_m[w][g] - mx);
      lsum += part_l[w][g] * e;
      a += part_acc[w][g][d] * e;
    }
    store(out + head + i, a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   void* out, int B, int S, int KV, int G, cudaStream_t stream) {
  const dim3 grid(KV, B);
  decode_attention_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), S, KV, G,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the rows split over a thread-block cluster
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kMaxSplit = 8;                 // blocks per cluster: the portable maximum
constexpr int kDecWarps = 4;

// lanes that read one cache row with 16-byte loads: D / 8 rounded up to a
// power of two, so that a row's dot products reduce with xor shuffles
template <int D>
__host__ __device__ constexpr int lanes_per_row() {
  return D <= 16 ? 2 : D <= 32 ? 4 : D <= 64 ? 8 : D <= 128 ? 16 : 32;
}

// weight of a partial softmax state of max m in a combined state of max mx;
// a state that saw no row (m = -inf) weighs 0
__device__ __forceinline__ float rescale(float m, float mx) {
  return m == neg_inf() ? 0.f : exp2f(m - mx);
}

template <int D, int GM>
__global__ void __launch_bounds__(kDecWarps * 32)
decode_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const int* __restrict__ lengths,
                             __nv_bfloat16* __restrict__ out, int S, int KV, int G,
                             float scale_log2) {
  constexpr int LPR = lanes_per_row<D>();
  constexpr int NP = kDecWarps * (32 / LPR); // row streams of a block
  constexpr int U = GM > 4 ? 2 : 4;          // rows in flight per stream
  __shared__ float part_m[NP][GM];
  __shared__ float part_l[NP][GM];
  __shared__ float part_acc[NP][GM][D];
  __shared__ float blk_m[GM];
  __shared__ float blk_l[GM];
  __shared__ float blk_acc[GM][D];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int slot = (threadIdx.x >> 5) * (32 / LPR) + lane / LPR;  // the lane's stream
  const int col = (lane % LPR) * 8;
  const bool has_col = col < D;              // false for 6 of 16 lanes at D = 80

  const int len = lengths[b];
  const int n = len > 0 ? min(len, S) : S;   // rows to read
  const int per = (n + split - 1) / split;
  const int r0 = min(n, rank * per);
  const int r1 = min(n, r0 + per);

  const int64_t head = (static_cast<int64_t>(b) * KV + kvh) * G * D;
  float qf[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G && has_col) {
      load8(q + head + g * D + col, qf[g]);
#pragma unroll
      for (int c = 0; c < 8; ++c) qf[g][c] *= scale_log2;
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) qf[g][c] = 0.f;
    }
  }
  float m[GM], l[GM], acc[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = neg_inf();
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[g][c] = 0.f;
  }

  const int64_t rs = static_cast<int64_t>(KV) * D;
  const int64_t base = (static_cast<int64_t>(b) * S * KV + kvh) * D + col;
  for (int r = r0; r < r1; r += NP * U) {    // block-uniform trip count
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {            // all U rows in flight first
      const int j = r + u * NP + slot;
      if (j < r1 && has_col) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(k + base + j * rs));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(v + base + j * rs));
      } else {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float s[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[8];
      unpack8(kr[u], kx);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) a = fmaf(qf[g][c], kx[c], a);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        s[u][g] = a;
      }
    }
    if (r + slot < r1) {                     // the stream holds at least one row
      float vx[U][8];
#pragma unroll
      for (int u = 0; u < U; ++u) unpack8(vr[u], vx[u]);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          float mx = m[g];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const bool row = r + u * NP + slot < r1;
            s[u][g] = !row ? neg_inf() : len > 0 ? s[u][g] : kNegInf;
            mx = fmaxf(mx, s[u][g]);
          }
          const float alpha = exp2f(m[g] - mx);  // 0 while m = -inf
          m[g] = mx;
          l[g] *= alpha;
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[g][c] *= alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float p = exp2f(s[u][g] - mx);
            l[g] += p;
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[g][c] = fmaf(p, vx[u][c], acc[g][c]);
          }
        }
      }
    }
  }

  // the block's streams, combined in shared memory
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      if (lane % LPR == 0) {
        part_m[slot][g] = m[g];
        part_l[slot][g] = l[g];
      }
      if (has_col) {
#pragma unroll
        for (int c = 0; c < 8; ++c) part_acc[slot][g][col + c] = acc[g][c];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kDecWarps * 32) {
    const int g = i / D;
    const int d = i % D;
    float mx = neg_inf();
    for (int p = 0; p < NP; ++p) mx = fmaxf(mx, part_m[p][g]);
    float ls = 0.f, a = 0.f;
    for (int p = 0; p < NP; ++p) {
      const float w = rescale(part_m[p][g], mx);
      ls += part_l[p][g] * w;
      a += part_acc[p][g][d] * w;
    }
    blk_acc[g][d] = a;
    if (d == 0) {
      blk_m[g] = mx;
      blk_l[g] = ls;
    }
  }

  // the cluster's blocks, combined through distributed shared memory: each
  // block takes every split-th run of 128 outputs and reads all blocks'
  // states for them in rank order
  cluster.sync();
  for (int i = rank * kDecWarps * 32 + threadIdx.x; i < G * D;
       i += split * kDecWarps * 32) {
    const int g = i / D;
    const int d = i % D;
    float mx = neg_inf();
    for (int r = 0; r < split; ++r) mx = fmaxf(mx, *cluster.map_shared_rank(&blk_m[g], r));
    float ls = 0.f, a = 0.f;
    for (int r = 0; r < split; ++r) {
      const float w = rescale(*cluster.map_shared_rank(&blk_m[g], r), mx);
      ls += *cluster.map_shared_rank(&blk_l[g], r) * w;
      a += *cluster.map_shared_rank(&blk_acc[g][d], r) * w;
    }
    store(out + head + i, a / fmaxf(ls, 1e-30f));
  }
  cluster.sync();                            // every block has read the others
}

template <int D, int GM>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* lengths,
                        void* out, int B, int S, int KV, int G, cudaStream_t stream) {
  static int sms = 0;                        // the card's SM count, read once
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  int split = kMaxSplit;
  while (split > 1 && (static_cast<int64_t>(B) * KV * split > 4 * sms || split * 16 > S)) {
    split /= 2;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, KV, B);
  cfg.blockDim = dim3(kDecWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_attention_bf16_kernel<D, GM>, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), S, KV, G,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)) * kLog2e));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// G rounded up to 1, 2, 4 or 8 accumulators per lane and column
template <int D>
cudaError_t launch_bf16_g(const void* q, const void* k, const void* v, const void* lengths,
                          void* out, int B, int S, int KV, int G, cudaStream_t stream) {
  if (G <= 1) return launch_bf16<D, 1>(q, k, v, lengths, out, B, S, KV, G, stream);
  if (G <= 2) return launch_bf16<D, 2>(q, k, v, lengths, out, B, S, KV, G, stream);
  if (G <= 4) return launch_bf16<D, 4>(q, k, v, lengths, out, B, S, KV, G, stream);
  return launch_bf16<D, 8>(q, k, v, lengths, out, B, S, KV, G, stream);
}

// the storage type picks the kernel: bf16 the cluster split, f32 the CUDA cores
template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, const void* lengths,
                         void* out, int B, int S, int KV, int G, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_bf16_g<D>(q, k, v, lengths, out, B, S, KV, G, stream);
  } else {
    return launch<T, D>(q, k, v, lengths, out, B, S, KV, G, stream);
  }
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* lengths,
                       void* out, int B, int S, int KV, int G, int D,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch_typed<T, 16>(q, k, v, lengths, out, B, S, KV, G, stream);
    case 32: return launch_typed<T, 32>(q, k, v, lengths, out, B, S, KV, G, stream);
    case 64: return launch_typed<T, 64>(q, k, v, lengths, out, B, S, KV, G, stream);
    case 80: return launch_typed<T, 80>(q, k, v, lengths, out, B, S, KV, G, stream);
    case 128: return launch_typed<T, 128>(q, k, v, lengths, out, B, S, KV, G, stream);
    case 256: return launch_typed<T, 256>(q, k, v, lengths, out, B, S, KV, G, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* out, int B, int S,
                                      int KV, int G, int D, int dtype, void* stream) {
  using namespace repro_torch;
  if (G < 1 || G > kMaxG) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(q, k, v, lengths, out, B, S, KV, G, D, st);
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(q, k, v, lengths, out, B, S, KV, G, D, st);
  }
  return cudaErrorInvalidValue;
}
