// The SwiGLU / GeGLU gate of the decode step's MLP, hand-written for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference leaves the gate (src/repro/models/mlp.py)
// to XLA, which fuses it.  PyTorch runs it as an activation kernel and a
// product kernel with a bf16 tensor between them; this kernel is both in one
// pass (ops.py `glu_gate_plain` is the pair itself).
//
//   act = bf16(bf16(f(gate)) * up),  f = SiLU (kind 0), tanh-GELU (kind 1) or
//   the exact erf GELU (kind 2, Zamba2's)
//
// computed in f32 with the pair's rounding points: f(gate) is rounded to bf16
// before the product, as F.silu / F.gelu return it.  SiLU is x / (1 + exp(-x))
// tanh-GELU 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))) and erf-GELU
// x 0.5 (1 + erf(x / sqrt 2)), written as PyTorch's CUDA kernels write them,
// with the precise expf, tanhf and erff.
//
// Layouts (contiguous, bf16): gate, up, act (n,), n a multiple of 8.
//
// One thread per 8 elements, 16-byte loads and stores, 256 threads a block.
//
// What bounds it on the H100: the bytes (gate and up read once, act written
// once: 6 n bytes, 1.3 MB at h2o-danube-1.8b's d_ff 6912 and 16 rows), so the
// launch bounds it at the served shapes.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

template <int kKind>
__device__ __forceinline__ float activation(float x) {
  if (kKind == 0) return x / (1.f + expf(-x));
  if (kKind == 2) {
    constexpr float kAlpha = 0.70710678118654752f;  // 1 / sqrt(2)
    return x * 0.5f * (1.f + erff(x * kAlpha));
  }
  constexpr float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  constexpr float kKappa = 0.044715f;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
    glu_gate_kernel(const __nv_bfloat16* __restrict__ gate, const __nv_bfloat16* __restrict__ up,
                    __nv_bfloat16* __restrict__ act, long long runs) {
  allow_next_grid();                         // common.cuh
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= runs) return;
  float g[8], u[8], o[8];
  load8(gate + 8 * i, g);
  load8(up + 8 * i, u);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __fmul_rn(round_bf16(activation<kKind>(g[e])), u[e]);
  store8(act + 8 * i, o);
}

}  // namespace
}  // namespace repro_torch

// kind: 0 = SwiGLU (SiLU), 1 = GeGLU (tanh-GELU), 2 = GeGLU (erf-GELU).  Returns
// the cudaError_t of the launch.
extern "C" int repro_glu_gate(const void* gate, const void* up, void* act, long long n, int kind,
                              void* stream) {
  using namespace repro_torch;
  if (n < 8 || n % 8) return cudaErrorInvalidValue;
  const long long runs = n / 8;
  const unsigned blocks = static_cast<unsigned>((runs + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const __nv_bfloat16*>(gate);
  const auto* u = static_cast<const __nv_bfloat16*>(up);
  auto* a = static_cast<__nv_bfloat16*>(act);
  if (kind == 0) {
    glu_gate_kernel<0><<<blocks, kThreads, 0, st>>>(g, u, a, runs);
  } else if (kind == 1) {
    glu_gate_kernel<1><<<blocks, kThreads, 0, st>>>(g, u, a, runs);
  } else if (kind == 2) {
    glu_gate_kernel<2><<<blocks, kThreads, 0, st>>>(g, u, a, runs);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
