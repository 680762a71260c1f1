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
// Numerics: everything is f32, and every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn: no fused multiply-add), in the order of the plain
// PyTorch version (ops.py rwkv6_scan_plain): kv = k * v, the terms
// r * (S + u * kv), their sum over i as a pairwise tree (i with i + D/2, then
// i + D/4, ...), and S <- S * w + kv.  Kernel and plain version then agree bit
// for bit, which a model of many layers needs: it amplifies a difference in
// the order of that sum far beyond one rounding (PERF.md keeps the runs).
//
// Design: the TPU kernel's sequential grid axis over T becomes a loop inside
// one block per (head, batch row).  Four threads share each state column:
// thread (j, q) keeps rows i = q + 4 m (m < D/4) of column j in registers for
// the whole sequence, q in the low lane bits.  Its own pairwise tree over m
// is exactly the levels i <-> i + D/2 ... i <-> i + 4 of the tree over i; the
// last two levels (i <-> i + 2, i <-> i + 1) run across lanes with xor masks
// 2 and 1, each one rounded __fadd_rn of the same two partial sums, so the
// bits do not change.  Each thread serves two columns (j and j + D/2) with
// the rows it reads: a block is 2 D threads (4 warps at D 64, one block per
// SM at the prefill shape, B 4 x H 32 = 128 blocks on 132 SMs), and a step
// reads half the shared memory that one column per thread would.  kSteps = 4
// steps are computed together, and their 8 sums per thread (4 steps x 2
// columns) cross the lanes in one transposing reduction: at xor 2 a lane
// keeps the 4 sums its lane bit selects and adds the partner's copies, at
// xor 1 the same with 2, so 6 shuffles finish 8 sums (16 one at a time) and
// every lane stores 2 of them.  Chunks of kChunk steps of r, k, v, w arrive
// by cp.async in a double buffer (the next chunk in flight); one pass
// converts r, k, w to f32 and permutes them so that a thread's D/4 rows are
// contiguous (groups padded by 4 floats: the four groups of a 16-byte load
// fall on distinct banks).  u stays in registers.  The state is read and
// written coalesced through shared memory; s_out may alias s0: each block
// reads its own (b, h) state before anything is written and writes it back
// at the end, so a decode step updates a cache in place.
//
// What bounds it on the H100: the bytes (r/k/v/y in their type, w and the
// state in and out in f32: about 29 MB at the prefill serving shape B 4,
// T 256, H 32, D 64, 8.8 us at 3.35 TB/s) and the f32 arithmetic (4 D^2 per
// step and head at the f32 peak, 8 us) lie below what the exact contract
// costs: six rounded operations per state entry and step that cannot fuse
// (0.8 G at the prefill shape, on 128 of the 132 SMs), the shared-memory
// reads of r, k, w (each row read once per pair of columns) and each step's
// chain through the tree and the shuffles, times T.  chip_smoke.py computes
// the bound from the shapes and measures the kernel beside it (PERF.md keeps
// the numbers).
#include "common.cuh"
#include "mma.cuh"

namespace repro_torch {
namespace {

constexpr int kChunk = 32;                   // steps staged at a time
constexpr int kQ = 4;                        // threads per state column
constexpr int kCols = 2;                     // columns per thread
constexpr int kSteps = 4;                    // steps whose sums cross lanes together

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

// shared memory of one block, in bytes: the raw chunks of r, k, v (in T) and
// w (f32) twice, then r, k, w of one chunk in f32, permuted; the state is
// staged through the raw buffers before the first chunk and after the last
template <typename T, int D>
struct WkvSmem {
  static constexpr int G = D / kQ + 4;        // pitch of one thread group q
  static constexpr int SP = D + 8;           // pitch of a staged state row
  static constexpr int raw_t = kChunk * D * static_cast<int>(sizeof(T));
  static constexpr int raw = 3 * raw_t + kChunk * D * 4;   // one buffer
  static constexpr int perm = kChunk * kQ * G * 4;          // one array
  static constexpr int bytes = 2 * raw + 3 * perm;
  static_assert(D * SP * 4 <= 2 * raw, "the state fits the raw buffers");
};

// a step count as a type, for the steps lambda below
template <int U>
struct StepCount {
  static constexpr int value = U;
};

template <typename T, int D>
__global__ void __launch_bounds__(kQ * D / kCols)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* s0,
                  T* __restrict__ y, float* s_out, int Tn, int H) {
  using L = WkvSmem<T, D>;
  constexpr int C = kCols;
  constexpr int NT = kQ * D / C;
  constexpr int M = D / kQ;                  // rows per thread
  constexpr int G = L::G;
  constexpr int SP = L::SP;
  constexpr int RP = D * static_cast<int>(sizeof(T)) / 16;   // 16-byte pieces of a row
  constexpr int WP = D * 4 / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const st_s = reinterpret_cast<float*>(smem);
  float* const r_p = reinterpret_cast<float*>(smem + 2 * L::raw);
  float* const k_p = r_p + kChunk * kQ * G;
  float* const w_p = k_p + kChunk * kQ * G;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int j0 = tid / kQ;                   // columns j0 + c D / C
  const int q = tid % kQ;
  const int64_t state = (static_cast<int64_t>(b) * H + h) * D * D;

  // the state, coalesced through shared memory, into registers
  for (int i = tid; i < D * D / 4; i += NT) {
    const float4 val = reinterpret_cast<const float4*>(s0 + state)[i];
    *reinterpret_cast<float4*>(&st_s[(4 * i / D) * SP + 4 * i % D]) = val;
  }
  __syncthreads();
  float s[C][M], uu[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int c = 0; c < C; ++c) s[c][m] = st_s[(q + kQ * m) * SP + j0 + c * (D / C)];
    uu[m] = u[h * D + q + kQ * m];
  }
  __syncthreads();                           // the raw buffers are free

  const int64_t row = static_cast<int64_t>(H) * D;           // stride of t
  const int64_t base = (static_cast<int64_t>(b) * Tn * H + h) * D;
  auto raw = [&](int c) { return smem + (c & 1) * L::raw; };
  auto load_chunk = [&](int c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, Tn - t0);
    unsigned char* dst = raw(c);
    for (int i = tid; i < n * RP; i += NT) {
      const int tt = i / RP;
      const int e = (i % RP) * (16 / static_cast<int>(sizeof(T)));
      const int64_t src = base + (t0 + tt) * row + e;
      const int o = (tt * D + e) * static_cast<int>(sizeof(T));
      cp_async16(dst + o, r + src, 16);
      cp_async16(dst + L::raw_t + o, k + src, 16);
      cp_async16(dst + 2 * L::raw_t + o, v + src, 16);
    }
    for (int i = tid; i < n * WP; i += NT) {
      const int tt = i / WP;
      const int e = (i % WP) * 4;
      cp_async16(dst + 3 * L::raw_t + (tt * D + e) * 4, w + base + (t0 + tt) * row + e, 16);
    }
    cp_async_commit();
  };
  // the thread's rows of r, k, w at step tt of the permuted chunk
  auto load_rows = [&](int tt, float4 (&rr)[M / 4], float4 (&kk)[M / 4], float4 (&ww)[M / 4]) {
    const int o = tt * kQ * G + q * G;
#pragma unroll
    for (int m4 = 0; m4 < M / 4; ++m4) {
      rr[m4] = *reinterpret_cast<const float4*>(r_p + o + 4 * m4);
      kk[m4] = *reinterpret_cast<const float4*>(k_p + o + 4 * m4);
      ww[m4] = *reinterpret_cast<const float4*>(w_p + o + 4 * m4);
    }
  };

  const T* v_raw = nullptr;
  int t0 = 0;
  // U steps from tt of the staged chunk: terms, state, then the U sums
  auto steps = [&](auto n_steps, int tt) {
    constexpr int U = decltype(n_steps)::value;
    float term[U][C][M];
#pragma unroll
    for (int uu_ = 0; uu_ < U; ++uu_) {
      float4 rn[M / 4], kn[M / 4], wn[M / 4];
      load_rows(tt + uu_, rn, kn, wn);
      float rr[M], kk[M], ww[M];
#pragma unroll
      for (int m4 = 0; m4 < M / 4; ++m4) {
        rr[4 * m4] = rn[m4].x; rr[4 * m4 + 1] = rn[m4].y;
        rr[4 * m4 + 2] = rn[m4].z; rr[4 * m4 + 3] = rn[m4].w;
        kk[4 * m4] = kn[m4].x; kk[4 * m4 + 1] = kn[m4].y;
        kk[4 * m4 + 2] = kn[m4].z; kk[4 * m4 + 3] = kn[m4].w;
        ww[4 * m4] = wn[m4].x; ww[4 * m4 + 1] = wn[m4].y;
        ww[4 * m4 + 2] = wn[m4].z; ww[4 * m4 + 3] = wn[m4].w;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float vj = to_f32(v_raw[(tt + uu_) * D + j0 + c * (D / C)]);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float kv = __fmul_rn(kk[m], vj);
          term[uu_][c][m] = __fmul_rn(rr[m], __fadd_rn(s[c][m], __fmul_rn(uu[m], kv)));
          s[c][m] = __fadd_rn(__fmul_rn(s[c][m], ww[m]), kv);
        }
      }
    }
    // the sums over the thread's rows (the tree's first levels), value
    // x = u C + c for step tt + u and column j0 + c D / C
    constexpr int V = U * C;
    float part[V];
#pragma unroll
    for (int x = 0; x < V; ++x) {
      tree_sum<M>(term[x / C][x % C]);
      part[x] = term[x / C][x % C][0];
    }
    if constexpr (V % kQ == 0) {
      // the tree's last levels over the kQ lanes of a column group, halving
      // the values held at each level: at xor o a lane keeps the half its
      // o-bit selects and adds the partner's copy of it (one rounded add of
      // the same two partial sums as the tree's), so lane q ends with the
      // whole sums of values V / kQ q .. V / kQ q + V / kQ - 1
      int cur = V;
#pragma unroll
      for (int o = kQ / 2; o > 0; o >>= 1) {
        const bool upper = (q & o) != 0;
        cur /= 2;
#pragma unroll
        for (int x = 0; x < V / 2; ++x) {
          if (x < cur) {
            const float keep = upper ? part[x + cur] : part[x];
            const float send = upper ? part[x] : part[x + cur];
            part[x] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, o));
          }
        }
      }
#pragma unroll
      for (int e = 0; e < V / kQ; ++e) {
        const int x = V / kQ * q + e;
        store(y + base + (t0 + tt + x / C) * row + j0 + (x % C) * (D / C), part[e]);
      }
    } else {
#pragma unroll
      for (int x = 0; x < V; ++x) {
        float sum = part[x];
#pragma unroll
        for (int o = kQ / 2; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
        if (q == 0) store(y + base + (t0 + tt + x / C) * row + j0 + (x % C) * (D / C), sum);
      }
    }
  };

  const int nch = (Tn + kChunk - 1) / kChunk;
  load_chunk(0);
  for (int ch = 0; ch < nch; ++ch) {
    t0 = ch * kChunk;
    const int n = min(kChunk, Tn - t0);
    const T* r_raw = reinterpret_cast<const T*>(raw(ch));
    const T* k_raw = r_raw + kChunk * D;
    v_raw = k_raw + kChunk * D;
    const float* w_raw = reinterpret_cast<const float*>(v_raw + kChunk * D);
    cp_async_wait<0>();
    __syncthreads();                         // chunk ch landed; chunk ch - 1 done
    if (ch + 1 < nch) load_chunk(ch + 1);
    // r, k, w to f32, row i of step tt at [tt][(i % kQ) * G + i / kQ], eight
    // rows of one step per pass
    for (int i = tid; i < n * D / 8; i += NT) {
      const unsigned tt = static_cast<unsigned>(i) / (D / 8);
      const unsigned i0 = static_cast<unsigned>(i) % (D / 8) * 8;
      float rv[8], kv[8], wv[8];
      load8(r_raw + tt * D + i0, rv);
      load8(k_raw + tt * D + i0, kv);
      load8(w_raw + tt * D + i0, wv);
#pragma unroll
      for (unsigned e = 0; e < 8; ++e) {
        const unsigned o = tt * kQ * G + (i0 + e) % kQ * G + (i0 + e) / kQ;
        r_p[o] = rv[e];
        k_p[o] = kv[e];
        w_p[o] = wv[e];
      }
    }
    __syncthreads();
    // kSteps steps at a time (their sums cross the lanes together), the
    // rest of a ragged chunk one by one
    int tt = 0;
    for (; tt + kSteps <= n; tt += kSteps) steps(StepCount<kSteps>(), tt);
    for (; tt < n; ++tt) steps(StepCount<1>(), tt);
  }

  // the state back, through shared memory
  __syncthreads();                           // every thread is past its last step
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int c = 0; c < C; ++c) st_s[(q + kQ * m) * SP + j0 + c * (D / C)] = s[c][m];
  }
  __syncthreads();
  for (int i = tid; i < D * D / 4; i += NT) {
    reinterpret_cast<float4*>(s_out + state)[i] =
        *reinterpret_cast<const float4*>(&st_s[(4 * i / D) * SP + 4 * i % D]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* y, void* s_out, int B,
                   int Tn, int H, cudaStream_t stream) {
  using L = WkvSmem<T, D>;
  static bool configured = false;            // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_scan_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(H, B);
  rwkv6_scan_kernel<T, D><<<grid, kQ * D / kCols, L::bytes, stream>>>(
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
