// WKV6 recurrence (RWKV-6 time mix), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/rwkv6_scan.py
// rwkv6_scan_pallas (wrapper ops.py rwkv6_scan).  Per batch row b and head h,
// with a (D, D) state S:
//
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// Layouts (row-major, contiguous): r, k, v, y (B, T, H, D) in f32 or bf16 (one
// type for all four); w (B, T, H, D) f32; u (H, D) f32; s0, s_out (B, H, D, D)
// f32, S[i][j] at [b][h][i][j].  Any T >= 1; D in {16, 32, 64}.
//
// Design: the TPU kernel's sequential grid axis over T becomes a loop inside
// one block per (head, batch row), as in the public RWKV-6 CUDA kernel.  The
// block has D threads; thread j keeps column j of S in registers for the whole
// sequence and owns output column j.  Chunks of kChunk time steps of r, k, v, w
// are staged in shared memory (each thread loads its own column of every row,
// so a row is one coalesced load), u once.  s_out may alias s0: each block
// reads its own (b, h) state into registers before anything is written, and
// writes it back at the end, so a decode step updates a cache in place.
//
// Numerics: everything is f32, and every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn: no fused multiply-add), in the order of the plain
// PyTorch version (ops.py rwkv6_scan_plain): kv = k * v, the terms
// r * (S + u * kv), their sum over i as a pairwise tree (i with i + D/2, then
// i + D/4, ...), and S <- S * w + kv.  Kernel and plain version then agree bit
// for bit, which a model of many layers needs: it amplifies a difference in
// the order of that sum far beyond one rounding (PERF.md keeps the runs).
//
// What bounds it on the H100: the bytes moved (r/k/v/y in their type, w and
// the state in and out in f32: about 29 MB at the prefill serving shape B 4,
// T 256, H 32, D 64, 9 us at 3.35 TB/s) and the f32 arithmetic (4 D^2 per
// step and head, 0.54 GFLOP there, 8 us at 67 TFLOP/s) are both far below the
// time of the sequential T loop: B x H = 128 blocks of 64 threads leave each SM
// with two warps, so one step's latency times T bounds it.  chip_smoke.py
// computes the bound from the shapes and measures the kernel beside it
// (PERF.md keeps the numbers).
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kChunk = 16;

// t[0] <- sum of t[0..N) as a pairwise tree: t[i] += t[i + N/2] for i < N/2,
// then the same on the first half.  A template, so every index is a constant
// and t stays in registers.
template <int N>
__device__ __forceinline__ void tree_sum(float* t) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) t[i] = __fadd_rn(t[i], t[i + N / 2]);
  tree_sum<N / 2>(t);
}

template <>
__device__ __forceinline__ void tree_sum<1>(float*) {}

template <typename T, int D>
__global__ void __launch_bounds__(D)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* s0,
                  T* __restrict__ y, float* s_out, int Tn, int H) {
  __shared__ __align__(16) float r_s[kChunk][D];
  __shared__ __align__(16) float k_s[kChunk][D];
  __shared__ __align__(16) float v_s[kChunk][D];
  __shared__ __align__(16) float w_s[kChunk][D];
  __shared__ __align__(16) float u_s[D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const int64_t state = (static_cast<int64_t>(b) * H + h) * D * D;

  float s[D];
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] = s0[state + i * D + j];
  u_s[j] = u[h * D + j];

  const int64_t row = static_cast<int64_t>(H) * D;           // stride of t
  const int64_t base = (static_cast<int64_t>(b) * Tn * H + h) * D + j;
  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    const int n = min(kChunk, Tn - t0);
    __syncthreads();                        // the previous chunk is consumed
    for (int tt = 0; tt < n; ++tt) {
      const int64_t idx = base + (t0 + tt) * row;
      r_s[tt][j] = to_f32(r[idx]);
      k_s[tt][j] = to_f32(k[idx]);
      v_s[tt][j] = to_f32(v[idx]);
      w_s[tt][j] = w[idx];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt][j];
      float term[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float kv = __fmul_rn(k_s[tt][i], vj);
        term[i] = __fmul_rn(r_s[tt][i], __fadd_rn(s[i], __fmul_rn(u_s[i], kv)));
        s[i] = __fadd_rn(__fmul_rn(s[i], w_s[tt][i]), kv);
      }
      tree_sum<D>(term);
      store(y + base + (t0 + tt) * row, term[0]);
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) s_out[state + i * D + j] = s[i];
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* y, void* s_out, int B,
                   int Tn, int H, cudaStream_t stream) {
  const dim3 grid(H, B);
  rwkv6_scan_kernel<T, D><<<grid, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(s_out),
      Tn, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* r, const void* k, const void* v, const void* w,
                       const void* u, const void* s0, void* y, void* s_out, int B,
                       int Tn, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, y, s_out, B, Tn, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, y, s_out, B, Tn, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, y, s_out, B, Tn, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// dtype of r, k, v, y: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of
// the launch.
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0,
                                void* y, void* s_out, int B, int T, int H, int D,
                                int dtype, void* stream) {
  using namespace repro_torch;
  if (B < 1 || T < 1 || H < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(r, k, v, w, u, s0, y, s_out, B, T, H, D, st);
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, T, H, D, st);
  }
  return cudaErrorInvalidValue;
}
