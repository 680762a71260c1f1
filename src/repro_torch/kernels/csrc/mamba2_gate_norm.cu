// The Mamba2 decode step's D-skip and gated group norm, hand-written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference leaves the D-skip after the SSD scan,
// the cast back, the gate y * silu(z) and the norm (src/repro/models/mamba2.py)
// to XLA, which fuses them.  PyTorch runs that chain as about fifteen small
// kernels a layer; this kernel is the chain in one pass (ops.py
// `mamba2_gate_norm_plain` is the chain itself).  Per row, channel c of head
// h = c / P and group g = c / (d_inner / G):
//
//   v   = bf16(y + f32(xc) * f32(d_skip[h]))         (the two f32 ops apart)
//   u   = bf16(v * bf16(z / (1 + exp(-z))))          (y * silu(z))
//   out = bf16(u * rsqrt(mean_g(u^2) + eps) * (1 + scale))
//
// computed in f32 with the chain's rounding points: no product is fused into
// an add, the mean is the group's f32 sum times 1 / (d_inner / G), and each
// product of the norm is rounded on its own, as add_rms_norm.cu rounds them.
//
// Layouts: y (rows, d_inner) f32 (the scan's (rows, 1, H, P)); xc (rows,
// d_inner) bf16; d_skip (H,) f32 or bf16; z (rows, d_inner) bf16 with a row
// stride (the z half of the in-projection's z|x output); scale (d_inner,)
// bf16; out (rows, d_inner) bf16.  P and d_inner / G multiples of 8, d_inner /
// G at most 8 x 4 x 1024.
//
// One block per (group, row): (d_inner / G) / 8 threads (rounded up to whole
// warps, at most 1024), each holding up to four runs of 8 channels in
// registers between the sum and the scaling, with 16-byte accesses.  The sum
// of squares is reduced with xor shuffles within each warp and through shared
// memory across the warps.
//
// What bounds it on the H100: the bytes (y read in f32, xc, z and scale in
// bf16, out written: 12 d_inner bytes a row, 86 KB at Zamba2-7B's 7168), so
// the launch and one block's chain of loads, the reduction and the stores.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxRuns = 4;

__global__ void __launch_bounds__(1024)
    mamba2_gate_norm_kernel(const float* __restrict__ y, const __nv_bfloat16* __restrict__ xc,
                            const void* __restrict__ d_skip, int d_skip_bf16,
                            const __nv_bfloat16* __restrict__ z, long long z_stride,
                            const __nv_bfloat16* __restrict__ scale,
                            __nv_bfloat16* __restrict__ out, int d_inner, int group,
                            int head_dim, float inv_group, float eps) {
  __shared__ float part[32];
  allow_next_grid();                         // common.cuh
  const int row = blockIdx.y;
  const int first = blockIdx.x * group;
  const size_t base = static_cast<size_t>(row) * d_inner;
  const __nv_bfloat16* zr = z + row * z_stride;
  const int runs = group / 8;
  float v[kMaxRuns][8];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxRuns; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < runs) {
      const int ch = first + 8 * i;
      const int h = ch / head_dim;
      const float ds = d_skip_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(d_skip)[h])
                                   : static_cast<const float*>(d_skip)[h];
      float xv[8], zv[8];
      load8(y + base + ch, v[c]);
      load8(xc + base + ch, xv);
      load8(zr + ch, zv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float skipped = round_bf16(__fadd_rn(v[c][e], __fmul_rn(xv[e], ds)));
        const float gate = round_bf16(zv[e] / (1.f + expf(-zv[e])));
        v[c][e] = round_bf16(__fmul_rn(skipped, gate));
        ss += v[c][e] * v[c][e];
      }
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
  const float r = rsqrtf(__fadd_rn(__fmul_rn(part[0], inv_group), eps));
#pragma unroll
  for (int c = 0; c < kMaxRuns; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < runs) {
      const int ch = first + 8 * i;
      float s[8], o[8];
      load8(scale + ch, s);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = __fmul_rn(__fmul_rn(v[c][e], r), __fadd_rn(1.f, s[e]));
      store8(out + base + ch, o);
    }
  }
}

}  // namespace
}  // namespace repro_torch

// Returns the cudaError_t of the launch.
extern "C" int repro_mamba2_gate_norm(const void* y, const void* xc, const void* d_skip,
                                      int d_skip_bf16, const void* z, long long z_stride,
                                      const void* scale, void* out, int rows, int d_inner,
                                      int groups, int head_dim, float eps, void* stream) {
  using namespace repro_torch;
  if (rows < 1 || rows > 65535 || groups < 1 || d_inner % groups || head_dim < 8 ||
      head_dim % 8 || z_stride % 8) {
    return cudaErrorInvalidValue;
  }
  const int group = d_inner / groups, runs = group / 8;
  if (group < 8 || group % 8) return cudaErrorInvalidValue;
  const int threads = ((runs < 1024 ? runs : 1024) + 31) / 32 * 32;
  if (runs > kMaxRuns * threads) return cudaErrorInvalidValue;
  mamba2_gate_norm_kernel<<<dim3(groups, rows), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const __nv_bfloat16*>(xc), d_skip, d_skip_bf16,
      static_cast<const __nv_bfloat16*>(z), z_stride, static_cast<const __nv_bfloat16*>(scale),
      static_cast<__nv_bfloat16*>(out), d_inner, group, head_dim,
      1.f / static_cast<float>(group), eps);
  return cudaGetLastError();
}
