// RoPE of the decode step's q and k and the write of k and v into the KV
// cache, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference leaves `apply_rope` and the cache's
// dynamic_update_slice (src/repro/models/attention.py attention_decode) to
// XLA.  PyTorch runs RoPE as about 13 small kernels for each of q and k,
// recomputing the angles each time, and writes K and V with two index_copy_
// calls after computing the slot; this kernel is all of it in one pass (ops.py
// `rope_kv_write_plain` is that chain).
//
// One token a batch row at position p = *index (a device int32, so a
// captured step reads nothing back to the host).  For each head of q and k
// and each i < D / 2, split-halves RoPE in f32:
//
//   a = float(p) * freqs[i];  c, s = cos a, sin a   (the precise sincosf)
//   out[i] = x[i] c - x[i + D/2] s;  out[i + D/2] = x[i] s + x[i + D/2] c
//
// each product and sum rounded on its own (no fused multiply-add), as
// PyTorch's separate kernels round them, then rounded to bf16.  q goes to
// q_out; k and v go to the cache rows ck[b, slot], cv[b, slot], slot = p % S
// for a ring buffer (window > 0), else p.  A slot outside the cache traps,
// as the out-of-bounds index_copy_ it replaces asserts.
//
// Layouts (row-major, contiguous, bf16): q, q_out (B, H, D) (q_out read as
// (B, KV, G, D) by decode_attention: the same memory); k, v (B, KV, D); ck, cv
// (B, S, KV, D); freqs (D / 2,) f32; index () int32.  D even.
//
// One thread per (head, i) pair of one batch row: H D / 2 pairs of q, then
// KV D / 2 of k, then KV D / 2 of v (copied), 128 threads a block, the batch
// row on blockIdx.y.  Neighbouring threads touch neighbouring elements.
//
// What bounds it on the H100: the bytes (q, k, v read, q_out and the two
// cache rows written: 4 (H + 2 KV) D bytes a row), tens of KB at the served
// shapes, so the launch bounds it.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    rope_kv_write_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ index,
                         const float* __restrict__ freqs, __nv_bfloat16* __restrict__ q_out,
                         __nv_bfloat16* __restrict__ ck, __nv_bfloat16* __restrict__ cv, int H,
                         int KV, int D, int S, int window) {
  allow_next_grid();                         // common.cuh
  const int half = D / 2;
  const int nq = H * half, nk = KV * half;
  const int pair = blockIdx.x * kThreads + threadIdx.x;
  if (pair >= nq + 2 * nk) return;
  const size_t b = blockIdx.y;
  const int pos = *index;
  const int slot = window > 0 ? pos % S : pos;
  if (slot < 0 || slot >= S) __trap();
  if (pair >= nq + nk) {  // v: copied into its cache row
    const int r = pair - nq - nk, head = r / half, i = r % half;
    const __nv_bfloat16* src = v + (b * KV + head) * D;
    __nv_bfloat16* dst = cv + ((b * S + slot) * KV + head) * D;
    dst[i] = src[i];
    dst[i + half] = src[i + half];
    return;
  }
  const bool is_q = pair < nq;
  const int r = is_q ? pair : pair - nq, head = r / half, i = r % half;
  const __nv_bfloat16* src = is_q ? q + (b * H + head) * D : k + (b * KV + head) * D;
  __nv_bfloat16* dst = is_q ? q_out + (b * H + head) * D : ck + ((b * S + slot) * KV + head) * D;
  float s, c;
  sincosf(__fmul_rn(static_cast<float>(pos), freqs[i]), &s, &c);
  const float x1 = __bfloat162float(src[i]), x2 = __bfloat162float(src[i + half]);
  dst[i] = __float2bfloat16(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  dst[i + half] = __float2bfloat16(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
}

}  // namespace
}  // namespace repro_torch

// Returns the cudaError_t of the launch.
extern "C" int repro_rope_kv_write(const void* q, const void* k, const void* v,
                                   const void* index, const void* freqs, void* q_out, void* ck,
                                   void* cv, int B, int H, int KV, int D, int S, int window,
                                   void* stream) {
  using namespace repro_torch;
  if (B < 1 || KV < 1 || H % KV || D < 2 || D % 2 || S < 1 || B > 65535) {
    return cudaErrorInvalidValue;
  }
  const int pairs = (H + 2 * KV) * (D / 2);
  const dim3 grid((pairs + kThreads - 1) / kThreads, B);
  rope_kv_write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(index),
      static_cast<const float*>(freqs), static_cast<__nv_bfloat16*>(q_out),
      static_cast<__nv_bfloat16*>(ck), static_cast<__nv_bfloat16*>(cv), H, KV, D, S, window);
  return cudaGetLastError();
}
