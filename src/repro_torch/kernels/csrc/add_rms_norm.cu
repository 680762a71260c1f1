// Residual add + RMSNorm of the decode step, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference leaves `x + y` and `rms_norm`
// (src/repro/models/common.py) to XLA, which fuses them.  PyTorch runs the
// same chain as about ten small kernels a call (the f32 upcast, square, mean,
// rsqrt, two products, the cast back), twice a layer; this kernel is that
// chain in one pass (ops.py `add_rms_norm_plain` is the chain itself).
//
//   x_new = bf16(x + y)                                   (skipped when y is null)
//   h     = bf16(x_new * rsqrt(mean(x_new^2) + eps) * (1 + scale))
//
// computed in f32 with the chain's rounding points: the residual is rounded
// to bf16 before the norm reads it, the mean is the f32 sum times 1 / d, and
// each product is rounded on its own (no fused multiply-add), as PyTorch's
// separate kernels round them.
//
// Layouts (row-major, contiguous, bf16): x, y, x_new, h (rows, d); scale (d,).
// d a multiple of 8 and at most 8 x 4 x 1024.
//
// One block per row: d / 8 threads (rounded up to whole warps, at most 1024),
// each holding up to four runs of 8 elements in registers between the sum
// and the scaling, loaded and stored with 16-byte accesses.  The sum of
// squares is reduced with xor shuffles within each warp and through shared
// memory across the warps.
//
// What bounds it on the H100: the bytes (x, y and scale read once, x_new and
// h written once: 8 d bytes a row and 2 d for scale), a few hundred KB at the
// served shapes, so the launch and one block's chain of loads, the reduction
// and the stores bound it.  chip_smoke.py measures it beside that bound.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxRuns = 4;

__global__ void __launch_bounds__(1024)
    add_rms_norm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                        const __nv_bfloat16* __restrict__ scale,
                        __nv_bfloat16* __restrict__ x_new, __nv_bfloat16* __restrict__ h,
                        int d, float inv_d, float eps) {
  __shared__ float part[32];
  allow_next_grid();                         // common.cuh
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const int runs = d / 8;
  float v[kMaxRuns][8];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxRuns; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < runs) {
      load8(x + base + 8 * i, v[c]);
      if (y != nullptr) {
        float w[8];
        load8(y + base + 8 * i, w);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[c][e] = round_bf16(__fadd_rn(v[c][e], w[e]));
        store8(x_new + base + 8 * i, v[c]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) ss += v[c][e] * v[c][e];
    }
  }
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>((blockDim.x + 31) >> 5) ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(__fadd_rn(__fmul_rn(part[0], inv_d), eps));
#pragma unroll
  for (int c = 0; c < kMaxRuns; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < runs) {
      float s[8], o[8];
      load8(scale + 8 * i, s);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = __fmul_rn(__fmul_rn(v[c][e], r), __fadd_rn(1.f, s[e]));
      store8(h + base + 8 * i, o);
    }
  }
}

}  // namespace
}  // namespace repro_torch

// x_new and y may be null together (a plain norm of x).  Returns the
// cudaError_t of the launch.
extern "C" int repro_add_rms_norm(const void* x, const void* y, const void* scale, void* x_new,
                                  void* h, int rows, int d, float eps, void* stream) {
  using namespace repro_torch;
  const int runs = d / 8;
  if (rows < 1 || d < 8 || d % 8 || (y == nullptr) != (x_new == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int threads = ((runs < 1024 ? runs : 1024) + 31) / 32 * 32;
  if (runs > kMaxRuns * threads) return cudaErrorInvalidValue;
  add_rms_norm_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(scale), static_cast<__nv_bfloat16*>(x_new),
      static_cast<__nv_bfloat16*>(h), d, 1.f / static_cast<float>(d), eps);
  return cudaGetLastError();
}
