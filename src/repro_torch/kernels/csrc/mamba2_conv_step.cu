// The Mamba2 decode step's conv window, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference leaves the two depthwise causal convs
// of a decode step, dt's softplus and the widening of a_log
// (src/repro/models/mamba2.py) to XLA, which fuses them.  PyTorch runs that
// chain as about thirty small kernels a layer (the tap products and sums, the
// bias, SiLU, the cat and the window's copy back, the split of B and C, dt's
// cast, add and softplus, a_log's cast); this kernel is the chain in one pass
// (ops.py `mamba2_conv_step_plain` is the chain itself).  Per row and channel,
// with u the window's W - 1 inputs followed by the new one:
//
//   y      = bf16(... bf16(bf16(0 + bf16(u_0 w_0)) + bf16(u_1 w_1)) ...)
//   y      = bf16(y + bias)                                (where given)
//   out    = bf16(y / (1 + exp(-y)))                       (SiLU)
//   window = u_1 .. u_{W-1}                                (shifted by one)
//
// the taps summed from tap 0 with every product and sum rounded to bf16, as
// PyTorch's separate bf16 kernels round them.  Each head's
//
//   dt    = v > 20 ? v : log1p(exp(v)),  v = f32(dt_raw) + f32(dt_bias)
//   a_log = f32(a_log)
//
// in f32, the softplus with PyTorch's threshold 20 (beta 1).
//
// Layouts (bf16 unless said): xin (rows, d_inner) with a row stride (the x
// half of the in-projection's z|x output), bcin (rows, 2 G N) contiguous,
// the windows (rows, W - 1, channels) read from win_*_in and written to
// win_*_out (the same tensor for the decode cache's in-place update), conv
// weights (W, channels), biases (channels,) or null; xc (rows, d_inner), B
// and C (rows, G N) each; dt_raw (rows, H); dt_bias and a_log (H,) f32 or
// bf16; dt (rows, H) and a_log_out (H,) f32.  Every channel count a multiple
// of 8, W 4 (Mamba2's, every configuration's).
//
// One thread per 8 channels of a row (d_inner + 2 G N channels), with 16-byte
// loads and stores; each thread reads all W - 1 slots of its channels before
// it writes any, so the window shifts in place.  The threads after the
// channels' take one head of dt each (row 0's also a_log).
//
// What bounds it on the H100: the bytes (the window read and written, the
// weights and the inputs read, the outputs written: about 0.2 MB a row at
// Zamba2-7B's 7168 + 256 channels), so the launch bounds it.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kWidth = 4;

__device__ __forceinline__ float load_leaf(const void* p, int bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(kThreads)
    mamba2_conv_step_kernel(const __nv_bfloat16* __restrict__ xin, long long xin_stride,
                            const __nv_bfloat16* __restrict__ bcin,
                            const __nv_bfloat16* win_x_in, const __nv_bfloat16* win_bc_in,
                            __nv_bfloat16* win_x_out, __nv_bfloat16* win_bc_out,
                            const __nv_bfloat16* __restrict__ w_x,
                            const __nv_bfloat16* __restrict__ w_bc,
                            const __nv_bfloat16* __restrict__ b_x,
                            const __nv_bfloat16* __restrict__ b_bc,
                            const __nv_bfloat16* __restrict__ dt_raw, const void* dt_bias,
                            int dt_bias_bf16, const void* a_log, int a_log_bf16,
                            __nv_bfloat16* __restrict__ xc, __nv_bfloat16* __restrict__ b_out,
                            __nv_bfloat16* __restrict__ c_out, float* __restrict__ dt,
                            float* __restrict__ a_log_out, int d_inner, int gn, int heads) {
  allow_next_grid();                         // common.cuh
  const int row = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int runs_x = d_inner / 8, runs = runs_x + gn / 4;
  if (i >= runs) {
    const int h = i - runs;
    if (h < heads) {
      const float v = __fadd_rn(__bfloat162float(dt_raw[static_cast<size_t>(row) * heads + h]),
                                load_leaf(dt_bias, dt_bias_bf16, h));
      dt[static_cast<size_t>(row) * heads + h] = v > 20.f ? v : log1pf(expf(v));
      if (row == 0) a_log_out[h] = load_leaf(a_log, a_log_bf16, h);
    }
    return;
  }
  const bool is_x = i < runs_x;
  const int c = 8 * (is_x ? i : i - runs_x);
  const int chans = is_x ? d_inner : 2 * gn;
  const size_t slots = static_cast<size_t>(row) * (kWidth - 1) * chans;
  const __nv_bfloat16* in = is_x ? xin + row * xin_stride : bcin + static_cast<size_t>(row) * chans;
  const __nv_bfloat16* win = (is_x ? win_x_in : win_bc_in) + slots;
  __nv_bfloat16* wout = (is_x ? win_x_out : win_bc_out) + slots;
  const __nv_bfloat16* w = is_x ? w_x : w_bc;
  const __nv_bfloat16* bias = is_x ? b_x : b_bc;

  float u[kWidth][8];
#pragma unroll
  for (int s = 0; s < kWidth - 1; ++s) load8(win + static_cast<size_t>(s) * chans + c, u[s]);
  load8(in + c, u[kWidth - 1]);
  float y[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) y[e] = 0.f;
#pragma unroll
  for (int t = 0; t < kWidth; ++t) {
    float wt[8];
    load8(w + static_cast<size_t>(t) * chans + c, wt);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      y[e] = round_bf16(__fadd_rn(y[e], round_bf16(__fmul_rn(u[t][e], wt[e]))));
    }
  }
  if (bias != nullptr) {
    float bb[8];
    load8(bias + c, bb);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = round_bf16(__fadd_rn(y[e], bb[e]));
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) y[e] = y[e] / (1.f + expf(-y[e]));
  if (is_x) {
    store8(xc + static_cast<size_t>(row) * d_inner + c, y);
  } else if (c < gn) {
    store8(b_out + static_cast<size_t>(row) * gn + c, y);
  } else {
    store8(c_out + static_cast<size_t>(row) * gn + (c - gn), y);
  }
#pragma unroll
  for (int s = 0; s < kWidth - 1; ++s) store8(wout + static_cast<size_t>(s) * chans + c, u[s + 1]);
}

}  // namespace
}  // namespace repro_torch

// b_x and b_bc may be null (no conv bias).  Returns the cudaError_t of the
// launch.
extern "C" int repro_mamba2_conv_step(const void* xin, long long xin_stride, const void* bcin,
                                      const void* win_x_in, const void* win_bc_in,
                                      void* win_x_out, void* win_bc_out, const void* w_x,
                                      const void* w_bc, const void* b_x, const void* b_bc,
                                      const void* dt_raw, const void* dt_bias, int dt_bias_bf16,
                                      const void* a_log, int a_log_bf16, void* xc, void* b_out,
                                      void* c_out, void* dt, void* a_log_out, int rows,
                                      int d_inner, int gn, int heads, int width, void* stream) {
  using namespace repro_torch;
  if (rows < 1 || d_inner < 8 || d_inner % 8 || gn < 8 || gn % 8 || heads < 1 ||
      xin_stride % 8 || rows > 65535 || width != kWidth) {
    return cudaErrorInvalidValue;
  }
  const int items = d_inner / 8 + gn / 4 + heads;
  const dim3 grid((items + kThreads - 1) / kThreads, rows);
  using bf = __nv_bfloat16;
  mamba2_conv_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(xin), xin_stride, static_cast<const bf*>(bcin),
      static_cast<const bf*>(win_x_in), static_cast<const bf*>(win_bc_in),
      static_cast<bf*>(win_x_out), static_cast<bf*>(win_bc_out), static_cast<const bf*>(w_x),
      static_cast<const bf*>(w_bc), static_cast<const bf*>(b_x), static_cast<const bf*>(b_bc),
      static_cast<const bf*>(dt_raw), dt_bias, dt_bias_bf16, a_log, a_log_bf16,
      static_cast<bf*>(xc), static_cast<bf*>(b_out), static_cast<bf*>(c_out),
      static_cast<float*>(dt), static_cast<float*>(a_log_out), d_inner, gn, heads);
  return cudaGetLastError();
}
