// Causal sliding-window prefill attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/swa_prefill/swa_prefill.py
// swa_prefill_pallas (wrapper ops.py swa_prefill_attention): for each query
// position p, softmax(q_p . k_j * D^-0.5) over keys j with 0 <= p - j < window,
// applied to V, with the online softmax in f32, masked probabilities set to
// zero, and out = acc / max(l, 1e-30).  Full causal attention is window >= S.
//
// Layouts (row-major, contiguous): q, out (B, S, H, D); k, v (B, S, KV, D);
// query head h reads KV head h / (H / KV) directly (the TPU wrapper repeats
// K/V over the GQA groups instead).
//
// Design: one block per (64-row query tile, query head, batch row), 8 warps,
// each warp owning 8 query rows.  The block loops only over the 64-key K/V
// tiles that intersect [q0 - window + 1, q_last], staging each in shared
// memory as f32 (K rows padded to D + 1 floats so that lane-per-key reads hit
// distinct banks).  For each of its rows a warp scores two keys per lane,
// updates (m, l) with warp reductions, and accumulates P.V with each lane
// owning ceil(D / 32) output columns; a column past D (lanes 16-31 of the
// third group at D = 80) is never read, accumulated or stored.  Rows and keys
// past S are masked, so any S works.  D in {16, 32, 64, 80, 128}: D = 80 needs
// 63,744 bytes of shared memory, above the 48 KB default, which launch() opts
// in to.
//
// What bounds it on the H100: at the serving shape (S = 256, D = 64) the
// bytes to move and the operations to do are both small (chip_smoke.py
// computes the least time from each and measures the kernel beside them;
// PERF.md keeps the numbers), so launch overhead and the CUDA-core f32
// arithmetic (no tensor cores yet) bound it.  Staging K/V tiles in shared
// memory reads each K/V row once per block instead of once per query row,
// and the block skips every tile outside the window band.
#include <cmath>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 64;                    // query rows per block = keys per tile
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kTile / kWarps;

template <int D>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) * (kTile * D + kTile * (D + 1) + kTile * D + kWarps * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
swa_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   int S, int H, int KV, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int DPL = (D + 31) / 32;         // output columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;                         // [kTile][D], pre-scaled
  float* k_s = q_s + kTile * D;              // [kTile][DP]
  float* v_s = k_s + kTile * DP;             // [kTile][D]
  float* p_s = v_s + kTile * D;              // [kWarps][kTile]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q_last = min(q0 + kTile, S) - 1;

  // stage the q tile, scaled in f32 as the TPU kernel does
  for (int i = tid; i < kTile * D / 8; i += blockDim.x) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const int s = q0 + r;
    float x[8];
    if (s < S) {
      load8(q + ((static_cast<int64_t>(b) * S + s) * H + h) * D + c, x);
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) x[t] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) q_s[r * D + c + t] = x[t] * scale;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  const int k_first = max(0, q0 - window + 1);
  for (int k0 = (k_first / kTile) * kTile; k0 <= q_last; k0 += kTile) {
    __syncthreads();                         // the previous tile is consumed
    for (int i = tid; i < kTile * D / 8; i += blockDim.x) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      const int s = k0 + r;
      float kx[8], vx[8];
      if (s < S) {
        const int64_t off = ((static_cast<int64_t>(b) * S + s) * KV + kvh) * D + c;
        load8(k + off, kx);
        load8(v + off, vx);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) kx[t] = vx[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        k_s[r * DP + c + t] = kx[t];
        v_s[r * D + c + t] = vx[t];
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qpos = q0 + r;
      if (qpos < S) {                        // warp-uniform
        const float* qr = q_s + r * D;
        const float* ka = k_s + lane * DP;
        const float* kb = k_s + (lane + 32) * DP;
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float qd = qr[d];
          sa = fmaf(qd, ka[d], sa);
          sb = fmaf(qd, kb[d], sb);
        }
        // rel >= 0 implies the key lies before qpos < S
        const int rel_a = qpos - (k0 + lane);
        const int rel_b = rel_a - 32;
        const bool ok_a = rel_a >= 0 && rel_a < window;
        const bool ok_b = rel_b >= 0 && rel_b < window;
        sa = ok_a ? sa : kNegInf;
        sb = ok_b ? sb : kNegInf;
        const float m_new = fmaxf(m[rr], warp_max(fmaxf(sa, sb)));
        const float pa = ok_a ? expf(sa - m_new) : 0.f;
        const float pb = ok_b ? expf(sb - m_new) : 0.f;
        const float alpha = expf(m[rr] - m_new);
        l[rr] = l[rr] * alpha + warp_sum(pa + pb);
        m[rr] = m_new;
        float* pw = p_s + warp * kTile;
        pw[lane] = pa;
        pw[lane + 32] = pb;
        __syncwarp();
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            float a = acc[rr][i] * alpha;
#pragma unroll 8
            for (int j = 0; j < kTile; ++j) a = fmaf(pw[j], v_s[j * D + d], a);
            acc[rr][i] = a;
          }
        }
        __syncwarp();                        // pw is rewritten by the next row
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qpos = q0 + warp * kRowsPerWarp + rr;
    if (qpos < S) {
      const float denom = fmaxf(l[rr], 1e-30f);
      T* o = out + ((static_cast<int64_t>(b) * S + qpos) * H + h) * D;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) store(o + d, acc[rr][i] / denom);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int S, int H, int KV, int window, cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes<D>();
  static bool configured = false;            // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        swa_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  swa_prefill_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, KV, window,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
                       int S, int H, int KV, int D, int window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, H, KV, window, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, KV, window, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, KV, window, stream);
    case 80: return launch<T, 80>(q, k, v, out, B, S, H, KV, window, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, KV, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_swa_prefill(const void* q, const void* k, const void* v, void* out,
                                 int B, int S, int H, int KV, int D, int window,
                                 int dtype, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(q, k, v, out, B, S, H, KV, D, window, st);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, H, KV, D, window, st);
  return cudaErrorInvalidValue;
}
