// Mamba2 SSD recurrence, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py
// ssd_scan_pallas (wrapper ops.py ssd_scan).  Per batch row b and head h, with
// a (P, N) f32 state and a = exp(-exp(a_log[h]) * dt_t):
//
//   h[p][n] <- a * h[p][n] + (dt_t * x_t[p]) * B_t[n]
//   y_t[p]   = sum_n h[p][n] * C_t[n]
//
// Layouts (row-major, contiguous): x (B, T, H, P) and b, c (B, T, N) in f32 or
// bf16 (one type for the three; B and C are shared by every head); dt (B, T, H)
// f32, after the softplus; a_log (H,) f32; h0, h_out (B, H, P, N) f32; y
// (B, T, H, P) in f32 or in x's type.  Any T >= 1; P in {32, 64}, N in
// {16, 64} (zamba2-2.7b and its reduced cut).
//
// Design: the TPU kernel's chunked matmul form (its grid walks T in chunks and
// carries the state in VMEM) becomes the plain recurrence in a loop inside one
// block per (head, batch row).  The block has P * N / 16 threads: R = N / 16
// threads share state row p, and thread q of the row keeps the 16 entries
// n = q + R * j (j = 0..15) of that row in registers for the whole sequence.
// Chunks of kChunk steps of x, B, C and the step's decay a (computed once per
// step by one thread) are staged in shared memory, B and C permuted so that a
// thread's 16 values are contiguous.  The state is read and written through
// shared memory so that both global passes are coalesced.  h_out may alias h0:
// each block reads its own (b, h) state before anything is written and writes
// it back at the end, so a decode step updates a cache in place.
//
// Numerics: everything is f32, and every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn: no fused multiply-add), in the order of the plain
// PyTorch version (ops.py ssd_scan_plain): a = exp(-(exp(a_log) * dt)),
// dtx = x * dt, h <- h * a + dtx * B, and the sum over n of h * C as a pairwise
// tree (n with n + N/2, then n + N/4, ...).  With the strided ownership the
// first four levels of that tree lie inside a thread and the last log2(R) are
// xor shuffles, so kernel and plain version agree bit for bit, which a model
// of many layers needs (PERF.md keeps the runs).
//
// What bounds it on the H100: the bytes moved (x and y in their type, B, C, dt,
// and the state read and written in f32: about 32 MB at the prefill serving
// shape B 4, T 256, H 80, P 64, N 64, 9.6 us at 3.35 TB/s; 10.6 MB and 3.2 us
// for a decode step) and the f32 arithmetic (1.34 GFLOP there, 20 us at
// 67 TFLOP/s) are both below the time of the sequential T loop: B x H = 320
// blocks of 256 threads, about 110 instructions per thread and step, 256 steps
// in order.  chip_smoke.py computes the bound from the shapes and measures the
// kernel beside it.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kChunk = 32;
constexpr int kJ = 16;                       // state entries per thread

// t[0] <- sum of t[0..M) as a pairwise tree: t[i] += t[i + M/2] for i < M/2,
// then the same on the first half.  A template, so every index is a constant
// and t stays in registers.
template <int M>
__device__ __forceinline__ void tree_sum(float* t) {
#pragma unroll
  for (int i = 0; i < M / 2; ++i) t[i] = __fadd_rn(t[i], t[i + M / 2]);
  tree_sum<M / 2>(t);
}

template <>
__device__ __forceinline__ void tree_sum<1>(float*) {}

template <typename T, typename TY, int P, int N>
__global__ void __launch_bounds__(P * N / kJ)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* h0, TY* __restrict__ y,
                float* h_out, int Tn, int H) {
  constexpr int R = N / kJ;                  // threads per state row
  constexpr int NT = P * R;                  // threads per block
  constexpr int HS = N + 4;                  // padded row of the staged state
  __shared__ __align__(16) float x_s[kChunk][P];
  __shared__ __align__(16) float b_s[kChunk][N];   // permuted: [q * 16 + j]
  __shared__ __align__(16) float c_s[kChunk][N];
  __shared__ float dt_s[kChunk];
  __shared__ float a_s[kChunk];
  __shared__ __align__(16) float h_s[P * HS];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int p = tid / R;
  const int q = tid % R;
  const int64_t state = (static_cast<int64_t>(b) * H + h) * P * N;

  // the state, coalesced through shared memory, into registers
  for (int i = tid; i < P * N / 4; i += NT) {
    const float4 v = reinterpret_cast<const float4*>(h0 + state)[i];
    const int r = (4 * i) / N;
    const int c = (4 * i) % N;
    *reinterpret_cast<float4*>(&h_s[r * HS + c]) = v;
  }
  __syncthreads();
  float hr[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) hr[j] = h_s[p * HS + q + R * j];
  const float ea = expf(a_log[h]);

  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    const int n = min(kChunk, Tn - t0);
    __syncthreads();                         // the previous chunk is consumed
    for (int i = tid; i < n * P; i += NT) {
      const int tt = i / P;
      x_s[tt][i % P] = to_f32(x[((static_cast<int64_t>(b) * Tn + t0 + tt) * H + h) * P + i % P]);
    }
    for (int i = tid; i < n * N; i += NT) {
      const int tt = i / N;
      const int nn = i % N;
      const int64_t src = (static_cast<int64_t>(b) * Tn + t0 + tt) * N + nn;
      const int dst = (nn % R) * kJ + nn / R;
      b_s[tt][dst] = to_f32(bm[src]);
      c_s[tt][dst] = to_f32(cm[src]);
    }
    if (tid < n) {
      const float d = dt[(static_cast<int64_t>(b) * Tn + t0 + tid) * H + h];
      dt_s[tid] = d;
      a_s[tid] = expf(-__fmul_rn(ea, d));
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float a = a_s[tt];
      const float dtx = __fmul_rn(x_s[tt][p], dt_s[tt]);
      float bv[kJ], cv[kJ], term[kJ];
#pragma unroll
      for (int j = 0; j < kJ; j += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&b_s[tt][q * kJ + j]);
        const float4 c4 = *reinterpret_cast<const float4*>(&c_s[tt][q * kJ + j]);
        bv[j] = b4.x; bv[j + 1] = b4.y; bv[j + 2] = b4.z; bv[j + 3] = b4.w;
        cv[j] = c4.x; cv[j + 1] = c4.y; cv[j + 2] = c4.z; cv[j + 3] = c4.w;
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        hr[j] = __fadd_rn(__fmul_rn(hr[j], a), __fmul_rn(dtx, bv[j]));
        term[j] = __fmul_rn(hr[j], cv[j]);
      }
      tree_sum<kJ>(term);
      float s = term[0];
#pragma unroll
      for (int o = R / 2; o > 0; o >>= 1) {
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      }
      if (q == 0) store(y + ((static_cast<int64_t>(b) * Tn + t0 + tt) * H + h) * P + p, s);
    }
  }

  // the state back, through shared memory (h_s is no longer read)
#pragma unroll
  for (int j = 0; j < kJ; ++j) h_s[p * HS + q + R * j] = hr[j];
  __syncthreads();
  for (int i = tid; i < P * N / 4; i += NT) {
    const int r = (4 * i) / N;
    const int c = (4 * i) % N;
    reinterpret_cast<float4*>(h_out + state)[i] =
        *reinterpret_cast<const float4*>(&h_s[r * HS + c]);
  }
}

template <typename T, typename TY, int P, int N>
cudaError_t launch(const void* x, const void* dt, const void* a_log, const void* bm,
                   const void* cm, const void* h0, void* y, void* h_out, int B,
                   int Tn, int H, cudaStream_t stream) {
  const dim3 grid(H, B);
  ssd_scan_kernel<T, TY, P, N><<<grid, P * N / kJ, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(h0), static_cast<TY*>(y),
      static_cast<float*>(h_out), Tn, H);
  return cudaGetLastError();
}

template <typename T, typename TY, int P>
cudaError_t dispatch_n(const void* x, const void* dt, const void* a_log, const void* bm,
                       const void* cm, const void* h0, void* y, void* h_out, int B,
                       int Tn, int H, int N, cudaStream_t st) {
  switch (N) {
    case 16: return launch<T, TY, P, 16>(x, dt, a_log, bm, cm, h0, y, h_out, B, Tn, H, st);
    case 64: return launch<T, TY, P, 64>(x, dt, a_log, bm, cm, h0, y, h_out, B, Tn, H, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename TY>
cudaError_t dispatch_p(const void* x, const void* dt, const void* a_log, const void* bm,
                       const void* cm, const void* h0, void* y, void* h_out, int B,
                       int Tn, int H, int P, int N, cudaStream_t st) {
  switch (P) {
    case 32: return dispatch_n<T, TY, 32>(x, dt, a_log, bm, cm, h0, y, h_out, B, Tn, H, N, st);
    case 64: return dispatch_n<T, TY, 64>(x, dt, a_log, bm, cm, h0, y, h_out, B, Tn, H, N, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// dtype of x, b, c: 0 = float32, 1 = bfloat16; y_dtype of y: 0 = float32,
// 1 = bfloat16 (bf16 only with bf16 x).  Returns the cudaError_t of the launch.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a_log,
                              const void* bm, const void* cm, const void* h0, void* y,
                              void* h_out, int B, int T, int H, int P, int N, int dtype,
                              int y_dtype, void* stream) {
  using namespace repro_torch;
  if (B < 1 || T < 1 || H < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && y_dtype == 0) {
    return dispatch_p<float, float>(x, dt, a_log, bm, cm, h0, y, h_out, B, T, H, P, N, st);
  }
  if (dtype == 1 && y_dtype == 1) {
    return dispatch_p<__nv_bfloat16, __nv_bfloat16>(x, dt, a_log, bm, cm, h0, y, h_out, B,
                                                    T, H, P, N, st);
  }
  if (dtype == 1 && y_dtype == 0) {
    return dispatch_p<__nv_bfloat16, float>(x, dt, a_log, bm, cm, h0, y, h_out, B, T, H, P,
                                            N, st);
  }
  return cudaErrorInvalidValue;
}
