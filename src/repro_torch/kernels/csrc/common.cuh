// Helpers shared by the kernels: element conversion, 16-byte loads and warp
// reductions.  Every kernel computes in f32 whatever its storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace repro_torch {

// the TPU kernels' finite mask value: a fully masked row stays finite
constexpr float kNegInf = -1e30f;

// exponentials in base 2 take scores scaled by log2(e)
constexpr double kLog2e = 1.4426950408889634;

// a true -inf, for lanes that hold no cache row at all
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Eight consecutive elements as f32 with one 16-byte load (bf16) or two
// (f32).  The address must be 16-byte aligned: the wrappers check the
// base pointers and every row starts at a multiple of D >= 16 elements.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// eight bf16 already loaded as one 16-byte word, as f32
__device__ __forceinline__ void unpack8(const uint4& u, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  unpack8(*reinterpret_cast<const uint4*>(p), out);
}

// eight f32 rounded to bf16 and stored with one 16-byte store
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* in) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Programmatic dependent launch (PDL).  decode_gemm is launched with the
// attribute: it may start once every block of the kernel before it in the
// stream has called allow_next_grid() (or exited), requests its first weight
// stages, which no kernel writes, and reads and writes nothing else before
// wait_for_prior_grid() returns, which is when the kernel before it has
// completed and its writes are visible.  The decode step's small fused
// kernels call allow_next_grid() first thing and are launched without the
// attribute, so each one's profiled time is its own.  allow_next_grid()
// does nothing where the next kernel lacks the attribute, and
// wait_for_prior_grid() nothing in a kernel launched without it.
__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace repro_torch
