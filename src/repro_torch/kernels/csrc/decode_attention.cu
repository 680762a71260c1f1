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
// lengths (B,) int32.
//
// Design: one block per (KV head, batch row) holding the G query rows in
// shared memory.  Its 4 warps stride over S in chunks of 32 cache rows: a lane
// scores its own row against all G queries (16-byte vector loads), the warp
// updates each query's online softmax (m, l) in f32 with warp reductions and
// accumulates P.V with each lane owning ceil(D / 32) output columns; a column
// past D (lanes 16-31 of the third group at D = 80) is never read, accumulated
// or stored.  The warps' partial (m, l, acc) are then combined in shared
// memory.  D in {16, 32, 64, 80, 128}.
//
// What bounds it on the H100: the bytes of K and V read (every query of a KV
// head shares one pass over its cache rows, so arithmetic intensity is about
// G).  At the serving shape (B = 4, S = 321, KV = 3) the grid is only B x KV
// = 12 blocks, far fewer than the 132 SMs, so launch latency and a single SM's
// load rate bound it; splitting S across blocks with a combine pass is work
// for a later change.  chip_smoke.py computes the least time from the bytes
// and measures the kernel beside it (PERF.md keeps the numbers).
#include <cmath>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 8;

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

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* lengths,
                       void* out, int B, int S, int KV, int G, int D,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, lengths, out, B, S, KV, G, stream);
    case 32: return launch<T, 32>(q, k, v, lengths, out, B, S, KV, G, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, out, B, S, KV, G, stream);
    case 80: return launch<T, 80>(q, k, v, lengths, out, B, S, KV, G, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, out, B, S, KV, G, stream);
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
