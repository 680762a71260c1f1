// Mamba2 SSD scan, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py
// ssd_scan_pallas (wrapper ops.py ssd_scan).  Per batch row b and head h, with
// a (P, N) f32 state and a_t = exp(-exp(a_log[h]) * dt_t):
//
//   h[p][n] <- a_t * h[p][n] + (dt_t * x_t[p]) * B_t[n]
//   y_t[p]   = sum_n h[p][n] * C_t[n]
//
// Layouts (row-major, contiguous): x (B, T, H, P) and b, c (B, T, G, N) in f32
// or bf16 (one type for the three; head h reads group h / (H / G): G = 1 is B
// and C shared by every head, zamba2-7b has G = 2); dt (B, T, H)
// f32, after the softplus; a_log (H,) f32; h0, h_out (B, H, P, N) f32; y
// (B, T, H, P) in f32 or in x's type.  Any T >= 1; P in {32, 64}, N in
// {16, 64} (zamba2-2.7b and its reduced cut).  h_out may alias h0: each block
// reads its own (b, h) state before anything is written and writes it back at
// the end, so a decode step updates a cache in place.
//
// Two bodies, chosen by the storage type and T (repro_ssd_scan below):
//
// 1. The recurrence (f32 inputs, and bf16 with T < kChunkedMinT: the served
//    decode step, T 1 with y in f32).  One block of P * N / 16 threads per
//    (head, batch row): R = N / 16 threads share state row p, thread q of the
//    row keeps the 16 entries n = q + R * j in registers, and the block walks T
//    in order.  Every product and sum is rounded on its own (__fmul_rn /
//    __fadd_rn), in the order of ops.py ssd_scan_plain, with the sum over n as
//    a pairwise tree whose last log2(R) levels are xor shuffles, so kernel and
//    plain version agree bit for bit (a model of many layers needs that in
//    f32).  It is bound by one step's latency times T: about 110 instructions
//    per thread and step, 256 steps in order at the prefill shape.
//
// 2. The chunked form (bf16 x/B/C with T >= kChunkedMinT: the served
//    prefill), the TPU kernel's own algorithm.  Per chunk of kQ = 64 steps,
//    with acum the inclusive cumulative sum of loga = -exp(a_log) dt (f32):
//
//      G'  = (C B^T) o L o dt_j,  L_ij = exp(acum_i - acum_j) for i >= j, else 0
//      y   = exp(acum_i) (C h_in^T) + G' x
//      h   = exp(acum_last) h_in + x^T B',  B'_j = exp(acum_last - acum_j) dt_j B_j
//
//    dt is folded into G' and B' so that x, B and C, bf16 already, enter the
//    tensor cores exact.  One block of 4 warps per (head, batch row) walks the
//    chunks in order; warp w owns chunk rows 16 w .. 16 w + 15 of y and a
//    fixed set of (16 x 8) tiles of the f32 state, kept in registers in the
//    mma accumulator layout.  All products are mma.sync.m16n8k16 (bf16 in, f32
//    accumulators).  The three operands that are f32 intermediates (G', B' and
//    h_in) are each split into two bf16 halves, hi = bf16(v) and
//    lo = bf16(v - hi), and multiplied twice: |v - hi - lo| <= 2^-17 |v|, so
//    the products keep about 16 bits where one bf16 rounding would keep 8
//    (over 5 M outputs some y lie near 0, where 2^-9 per operand would cross
//    the reference's 5e-2).  TF32 would keep 11 bits and need its own
//    fragment layout; the split reuses the bf16 fragments, and two
//    accumulator tiles of G' side by side are the A fragment of G' x.  The
//    exponent is masked before exp: above the diagonal acum_i - acum_j > 0
//    could overflow, so it becomes -inf, whose exp is 0.  Rows past T (a
//    ragged last chunk) are filled with zeros by cp.async and get dt = 0, so
//    they add nothing to y or to the state and acum_last is the last valid
//    row's.  cp.async brings the next chunk's x while this one is computed
//    (two buffers), and its B and C while the state is updated (one buffer
//    each, free once S = C B^T and B' are taken): 74 KB of shared memory
//    per block at P = N = 64, so three blocks share an SM and the 320 blocks
//    of the prefill serving shape run in one wave (two buffers of B and C
//    would leave two blocks per SM and a second wave).  The state's bf16 halves and B' are staged in shared memory
//    (pitch + 8 bf16, so ldmatrix is free of bank conflicts).  ops.py
//    ssd_scan_chunked_plain takes the same steps with the same roundings in
//    PyTorch; the two differ by the order of f32 sums only.
//
// What bounds it on the H100: the bytes (x and y in their type, B, C, dt, the
// f32 state in and out: 32 MB at the prefill serving shape B 4, T 256, H 80,
// P 64, N 64, 9.6 us at 3.35 TB/s).  The chunked form's four products (C B^T,
// G' x, C h^T, x^T B': 2.7 GFLOP there) would take 2.7 us at the bf16
// tensor-core peak, the recurrence's 4 P N f32 operations per step 20 us at
// the f32 peak.  The chunked body is bound by the latency of its chain per
// chunk (loads, products, exponentials, two barriers) times the 4 chunks.
// chip_smoke.py computes the bound and measures the kernel beside it.
#include "common.cuh"
#include "mma.cuh"

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
                float* h_out, int Tn, int H, int G) {
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
  const int g = h / (H / G);                 // the head's group of B and C
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
      const int64_t src = ((static_cast<int64_t>(b) * Tn + t0 + tt) * G + g) * N + nn;
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
                   int Tn, int H, int G, cudaStream_t stream) {
  const dim3 grid(H, B);
  ssd_scan_kernel<T, TY, P, N><<<grid, P * N / kJ, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(h0), static_cast<TY*>(y),
      static_cast<float*>(h_out), Tn, H, G);
  return cudaGetLastError();
}

template <typename T, typename TY, int P>
cudaError_t dispatch_n(const void* x, const void* dt, const void* a_log, const void* bm,
                       const void* cm, const void* h0, void* y, void* h_out, int B,
                       int Tn, int H, int G, int N, cudaStream_t st) {
  switch (N) {
    case 16: return launch<T, TY, P, 16>(x, dt, a_log, bm, cm, h0, y, h_out, B, Tn, H, G, st);
    case 64: return launch<T, TY, P, 64>(x, dt, a_log, bm, cm, h0, y, h_out, B, Tn, H, G, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename TY>
cudaError_t dispatch_p(const void* x, const void* dt, const void* a_log, const void* bm,
                       const void* cm, const void* h0, void* y, void* h_out, int B,
                       int Tn, int H, int G, int P, int N, cudaStream_t st) {
  switch (P) {
    case 32: return dispatch_n<T, TY, 32>(x, dt, a_log, bm, cm, h0, y, h_out, B, Tn, H, G, N, st);
    case 64: return dispatch_n<T, TY, 64>(x, dt, a_log, bm, cm, h0, y, h_out, B, Tn, H, G, N, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the chunked form (bf16 x/B/C, T >= kChunkedMinT)
// ---------------------------------------------------------------------------

constexpr int kQ = 64;                       // chunk length: 4 warps x 16 rows
constexpr int kCWarps = kQ / 16;

using bf16 = __nv_bfloat16;

// v as hi = bf16(v) and lo = bf16(v - hi), two values at once, each half a
// bf16 pair (a in the low half)
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// shared memory of one block, offsets in bf16 elements; every part begins
// on a 16-byte boundary
template <int P, int N>
struct ChunkSmem {
  static constexpr int XP = P + 8;                    // pitch of x rows
  static constexpr int NP = N + 8;                    // of B, C, B', state rows
  static constexpr int x_off = 0;                     // x [2][kQ][XP]
  static constexpr int b_off = x_off + 2 * kQ * XP;   // B [kQ][NP]
  static constexpr int c_off = b_off + kQ * NP;       // C [kQ][NP]
  static constexpr int bh_off = c_off + kQ * NP;      // B' hi, lo [kQ][NP]
  static constexpr int bl_off = bh_off + kQ * NP;
  static constexpr int hh_off = bl_off + kQ * NP;     // state hi, lo [P][NP]
  static constexpr int hl_off = hh_off + P * NP;
  static constexpr int f_off = hl_off + P * NP;       // dt, acum [kQ] f32
  static constexpr size_t bytes = 2 * static_cast<size_t>(f_off) + 2 * kQ * sizeof(float);
};

template <typename TY, int P, int N>
__global__ void __launch_bounds__(kCWarps * 32)
ssd_chunked_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a_log, const bf16* __restrict__ bm,
                   const bf16* __restrict__ cm, const float* h0, TY* __restrict__ y,
                   float* h_out, int Tn, int H, int G) {
  using L = ChunkSmem<P, N>;
  constexpr int XP = L::XP;
  constexpr int NP = L::NP;
  constexpr int NT = kCWarps * 32;
  constexpr int KN = N / 16;                 // k-steps over n
  constexpr int PT = P / 8;                  // 8-column tiles of a y row
  // state tiles: warp w owns rows sp0 .. sp0 + 15 and NTW 8-column tiles
  constexpr int PW = P / 16;
  constexpr int NTW = N / 8 / (kCWarps / PW);
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  bf16* const sm = reinterpret_cast<bf16*>(ssd_smem);
  bf16* const bh_s = sm + L::bh_off;
  bf16* const bl_s = sm + L::bl_off;
  bf16* const hh_s = sm + L::hh_off;
  bf16* const hl_s = sm + L::hl_off;
  float* const dt_s = reinterpret_cast<float*>(sm + L::f_off);
  float* const acum_s = dt_s + kQ;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int g = h / (H / G);                 // the head's group of B and C
  const int64_t state = (static_cast<int64_t>(b) * H + h) * P * N;
  const int sp0 = (warp % PW) * 16;
  const int sn0 = (warp / PW) * NTW * 8;

  // the warp's state tiles in the accumulator layout: hs[t][0..1] at row
  // sp0 + gid, hs[t][2..3] at row sp0 + gid + 8, columns sn0 + 8 t + 2 tig..+1
  float hs[NTW][4];
#pragma unroll
  for (int t = 0; t < NTW; ++t) {
    const float* src = h0 + state + (sp0 + gid) * N + sn0 + 8 * t + 2 * tig;
    const float2 u = *reinterpret_cast<const float2*>(src);
    const float2 v = *reinterpret_cast<const float2*>(src + 8 * N);
    hs[t][0] = u.x; hs[t][1] = u.y; hs[t][2] = v.x; hs[t][3] = v.y;
  }
  // ... and its bf16 halves in shared memory, the B operand of C h^T
  auto stage_state = [&]() {
#pragma unroll
    for (int t = 0; t < NTW; ++t) {
      const int o = (sp0 + gid) * NP + sn0 + 8 * t + 2 * tig;
      uint32_t hi, lo;
      split_bf16x2(hs[t][0], hs[t][1], hi, lo);
      *reinterpret_cast<uint32_t*>(hh_s + o) = hi;
      *reinterpret_cast<uint32_t*>(hl_s + o) = lo;
      split_bf16x2(hs[t][2], hs[t][3], hi, lo);
      *reinterpret_cast<uint32_t*>(hh_s + o + 8 * NP) = hi;
      *reinterpret_cast<uint32_t*>(hl_s + o + 8 * NP) = lo;
    }
  };
  stage_state();

  // x of chunk c into buffer c % 2, B and C of chunk c into their one
  // buffer; rows past T are zero-filled
  auto load_x = [&](int c) {
    const int t0 = c * kQ;
    bf16* xd = sm + L::x_off + (c & 1) * kQ * XP;
    for (int i = tid; i < kQ * P / 8; i += NT) {
      const int r = i / (P / 8);
      const int col = (i % (P / 8)) * 8;
      const bool ok = t0 + r < Tn;
      const bf16* src = ok ? x + ((static_cast<int64_t>(b) * Tn + t0 + r) * H + h) * P + col : x;
      cp_async16(xd + r * XP + col, src, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  auto load_bc = [&](int c) {
    const int t0 = c * kQ;
    bf16* bd = sm + L::b_off;
    bf16* cd = sm + L::c_off;
    for (int i = tid; i < kQ * N / 8; i += NT) {
      const int r = i / (N / 8);
      const int col = (i % (N / 8)) * 8;
      const bool ok = t0 + r < Tn;
      const int64_t o = ((static_cast<int64_t>(b) * Tn + t0 + r) * G + g) * N + col;
      cp_async16(bd + r * NP + col, ok ? bm + o : bm, ok ? 16 : 0);
      cp_async16(cd + r * NP + col, ok ? cm + o : cm, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  // warp 0 holds the dt of the next chunk, two rows per lane (0 past T)
  auto load_dt = [&](int c, float& d0, float& d1) {
    const int r = c * kQ + 2 * lane;
    const int64_t o = (static_cast<int64_t>(b) * Tn + r) * H + h;
    d0 = r < Tn ? dt[o] : 0.f;
    d1 = r + 1 < Tn ? dt[o + H] : 0.f;
  };

  const float ea = expf(a_log[h]);
  const int nchunks = (Tn + kQ - 1) / kQ;
  float d0 = 0.f, d1 = 0.f;
  if (warp == 0) load_dt(0, d0, d1);
  load_x(0);
  load_bc(0);

  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kQ;
    const int nv = min(kQ, Tn - t0);
    const bf16* x_s = sm + L::x_off + (c & 1) * kQ * XP;
    const bf16* b_s = sm + L::b_off;
    const bf16* c_s = sm + L::c_off;
    cp_async_wait<0>();
    if (warp == 0) {
      // loga = -(exp(a_log) dt), 0 past T, and its inclusive sum over the chunk
      const float l0 = -(ea * d0);
      const float l1 = -(ea * d1);
      float s = l0 + l1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += v;
      }
      float before = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) before = 0.f;
      const float a0 = before + l0;
      dt_s[2 * lane] = d0;
      dt_s[2 * lane + 1] = d1;
      acum_s[2 * lane] = a0;
      acum_s[2 * lane + 1] = a0 + l1;
      if (c + 1 < nchunks) load_dt(c + 1, d0, d1);
    }
    __syncthreads();                         // chunk c staged; chunk c - 1 done
    if (c + 1 < nchunks) load_x(c + 1);

    // B'_j = B_j exp(acum_last - acum_j) dt_j, as bf16 halves (0 past T)
    const float alast = acum_s[kQ - 1];
    for (int i = tid; i < kQ * N / 2; i += NT) {
      const int r = i / (N / 2);
      const int col = (i % (N / 2)) * 2;
      const float wj = __expf(alast - acum_s[r]) * dt_s[r];
      const float2 bv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b_s + r * NP + col));
      uint32_t hi, lo;
      split_bf16x2(bv.x * wj, bv.y * wj, hi, lo);
      *reinterpret_cast<uint32_t*>(bh_s + r * NP + col) = hi;
      *reinterpret_cast<uint32_t*>(bl_s + r * NP + col) = lo;
    }

    const int i0 = warp * 16;
    if (i0 < nv) {                           // the warp's rows hold a step
      uint32_t cf[KN][4];                    // C of rows i0 .. i0 + 15
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) {
        ldmatrix_x4(cf[ks], c_s + (i0 + (lane & 7) + ((lane >> 3) & 1) * 8) * NP
                                + ks * 16 + (lane >> 4) * 8);
      }
      // y = exp(acum_i) (C h_hi^T + C h_lo^T) ...
      float yacc[PT][4];
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[pt][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) {
#pragma unroll
        for (int pp = 0; pp < PT / 2; ++pp) {
          const int o = (pp * 16 + (lane & 7) + (lane >> 4) * 8) * NP + ks * 16
                        + ((lane >> 3) & 1) * 8;
          uint32_t hf[4], lf[4];
          ldmatrix_x4(hf, hh_s + o);
          ldmatrix_x4(lf, hl_s + o);
          mma_bf16_16816(yacc[2 * pp], cf[ks], hf[0], hf[1]);
          mma_bf16_16816(yacc[2 * pp + 1], cf[ks], hf[2], hf[3]);
          mma_bf16_16816(yacc[2 * pp], cf[ks], lf[0], lf[1]);
          mma_bf16_16816(yacc[2 * pp + 1], cf[ks], lf[2], lf[3]);
        }
      }
      const int ra = i0 + gid;
      const int rb = ra + 8;
      const float aa = acum_s[ra];
      const float ab = acum_s[rb];
      const float ea_a = __expf(aa);
      const float ea_b = __expf(ab);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        yacc[pt][0] *= ea_a; yacc[pt][1] *= ea_a;
        yacc[pt][2] *= ea_b; yacc[pt][3] *= ea_b;
      }
      // S = C B^T over the 16-column blocks jp <= warp (the causal part)
      float g[2 * kCWarps][4];
#pragma unroll
      for (int jt = 0; jt < 2 * kCWarps; ++jt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) g[jt][e] = 0.f;
      }
#pragma unroll
      for (int jp = 0; jp < kCWarps; ++jp) {
        if (jp > warp) break;
#pragma unroll
        for (int ks = 0; ks < KN; ++ks) {
          uint32_t bf[4];
          ldmatrix_x4(bf, b_s + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * NP + ks * 16
                              + ((lane >> 3) & 1) * 8);
          mma_bf16_16816(g[2 * jp], cf[ks], bf[0], bf[1]);
          mma_bf16_16816(g[2 * jp + 1], cf[ks], bf[2], bf[3]);
        }
      }
      // G' = S exp(acum_i - acum_j) dt_j; above the diagonal the exponent is
      // -inf before exp, so G' is 0 there and nothing overflows
#pragma unroll
      for (int jt = 0; jt < 2 * kCWarps; ++jt) {
        if (jt / 2 > warp) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jt * 8 + 2 * tig + e;
          const float aj = acum_s[j];
          const float dj = dt_s[j];
          g[jt][e] = g[jt][e] * __expf(j <= ra ? aa - aj : neg_inf()) * dj;
          g[jt][2 + e] = g[jt][2 + e] * __expf(j <= rb ? ab - aj : neg_inf()) * dj;
        }
      }
      // ... + G'_hi x + G'_lo x; two accumulator tiles side by side are the A
      // fragment of one 16-column block
#pragma unroll
      for (int jp = 0; jp < kCWarps; ++jp) {
        if (jp > warp) break;
        uint32_t ahi[4], alo[4];
        split_bf16x2(g[2 * jp][0], g[2 * jp][1], ahi[0], alo[0]);
        split_bf16x2(g[2 * jp][2], g[2 * jp][3], ahi[1], alo[1]);
        split_bf16x2(g[2 * jp + 1][0], g[2 * jp + 1][1], ahi[2], alo[2]);
        split_bf16x2(g[2 * jp + 1][2], g[2 * jp + 1][3], ahi[3], alo[3]);
#pragma unroll
        for (int pp = 0; pp < PT / 2; ++pp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, x_s + (jp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XP
                                    + pp * 16 + (lane >> 4) * 8);
          mma_bf16_16816(yacc[2 * pp], ahi, vf[0], vf[1]);
          mma_bf16_16816(yacc[2 * pp + 1], ahi, vf[2], vf[3]);
          mma_bf16_16816(yacc[2 * pp], alo, vf[0], vf[1]);
          mma_bf16_16816(yacc[2 * pp + 1], alo, vf[2], vf[3]);
        }
      }
      // y stored once in its type; rows past T are not stored
      TY* ya = y + ((static_cast<int64_t>(b) * Tn + t0 + ra) * H + h) * P + 2 * tig;
      TY* yb = ya + static_cast<int64_t>(8) * H * P;
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        if (ra < nv) store2(ya + pt * 8, yacc[pt][0], yacc[pt][1]);
        if (rb < nv) store2(yb + pt * 8, yacc[pt][2], yacc[pt][3]);
      }
    }
    __syncthreads();                         // B' staged; h's halves, B, C read
    // B and C of the next chunk land while the state is updated: one buffer
    // each keeps the block at 74 KB, three blocks per SM
    if (c + 1 < nchunks) load_bc(c + 1);

    // h <- exp(acum_last) h + x^T B'_hi + x^T B'_lo on the warp's tiles
    const float el = __expf(alast);
#pragma unroll
    for (int t = 0; t < NTW; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) hs[t][e] *= el;
    }
#pragma unroll
    for (int kp = 0; kp < kQ / 32; ++kp) {   // 32 steps: two k-steps
      uint32_t xa[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        ldmatrix_x4_trans(xa[u], x_s + ((2 * kp + u) * 16 + (lane & 7) + (lane >> 4) * 8) * XP
                                     + sp0 + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int t = 0; t < NTW; ++t) {
        const int o = (kp * 32 + lane) * NP + sn0 + 8 * t;
        uint32_t bh[4], bl[4];
        ldmatrix_x4_trans(bh, bh_s + o);
        ldmatrix_x4_trans(bl, bl_s + o);
        mma_bf16_16816(hs[t], xa[0], bh[0], bh[1]);
        mma_bf16_16816(hs[t], xa[1], bh[2], bh[3]);
        mma_bf16_16816(hs[t], xa[0], bl[0], bl[1]);
        mma_bf16_16816(hs[t], xa[1], bl[2], bl[3]);
      }
    }
    stage_state();                           // read after the next barrier
  }

#pragma unroll
  for (int t = 0; t < NTW; ++t) {
    float* dst = h_out + state + (sp0 + gid) * N + sn0 + 8 * t + 2 * tig;
    store2(dst, hs[t][0], hs[t][1]);
    store2(dst + 8 * N, hs[t][2], hs[t][3]);
  }
}

template <typename TY, int P, int N>
cudaError_t launch_chunked(const void* x, const void* dt, const void* a_log, const void* bm,
                           const void* cm, const void* h0, void* y, void* h_out, int B,
                           int Tn, int H, int G, cudaStream_t stream) {
  constexpr size_t smem = ChunkSmem<P, N>::bytes;
  static bool configured = false;            // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunked_kernel<TY, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(H, B);
  ssd_chunked_kernel<TY, P, N><<<grid, kCWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), static_cast<const float*>(h0), static_cast<TY*>(y),
      static_cast<float*>(h_out), Tn, H, G);
  return cudaGetLastError();
}

template <typename TY, int P>
cudaError_t dispatch_chunked_n(const void* x, const void* dt, const void* a_log,
                               const void* bm, const void* cm, const void* h0, void* y,
                               void* h_out, int B, int Tn, int H, int G, int N,
                               cudaStream_t st) {
  switch (N) {
    case 16: return launch_chunked<TY, P, 16>(x, dt, a_log, bm, cm, h0, y, h_out, B, Tn, H, G, st);
    case 64: return launch_chunked<TY, P, 64>(x, dt, a_log, bm, cm, h0, y, h_out, B, Tn, H, G, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TY>
cudaError_t dispatch_chunked(const void* x, const void* dt, const void* a_log, const void* bm,
                             const void* cm, const void* h0, void* y, void* h_out, int B,
                             int Tn, int H, int G, int P, int N, cudaStream_t st) {
  switch (P) {
    case 32:
      return dispatch_chunked_n<TY, 32>(x, dt, a_log, bm, cm, h0, y, h_out, B, Tn, H, G, N, st);
    case 64:
      return dispatch_chunked_n<TY, 64>(x, dt, a_log, bm, cm, h0, y, h_out, B, Tn, H, G, N, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// G: the groups of b and c (H a multiple of G).  dtype of x, b, c: 0 = float32,
// 1 = bfloat16; y_dtype of y: 0 = float32,
// 1 = bfloat16 (bf16 only with bf16 x).  bf16 inputs with T >= kChunkedMinT
// take the chunked form, everything else the recurrence (ops.py
// CHUNKED_MIN_T is the same number).  Returns the cudaError_t of the launch.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a_log,
                              const void* bm, const void* cm, const void* h0, void* y,
                              void* h_out, int B, int T, int H, int P, int N, int G,
                              int dtype, int y_dtype, void* stream) {
  using namespace repro_torch;
  constexpr int kChunkedMinT = 16;
  if (B < 1 || T < 1 || H < 1 || G < 1 || H % G) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && y_dtype == 0) {
    return dispatch_p<float, float>(x, dt, a_log, bm, cm, h0, y, h_out, B, T, H, G, P, N, st);
  }
  if (dtype == 1 && y_dtype == 1) {
    if (T >= kChunkedMinT) {
      return dispatch_chunked<__nv_bfloat16>(x, dt, a_log, bm, cm, h0, y, h_out, B, T, H,
                                             G, P, N, st);
    }
    return dispatch_p<__nv_bfloat16, __nv_bfloat16>(x, dt, a_log, bm, cm, h0, y, h_out, B,
                                                    T, H, G, P, N, st);
  }
  if (dtype == 1 && y_dtype == 0) {
    if (T >= kChunkedMinT) {
      return dispatch_chunked<float>(x, dt, a_log, bm, cm, h0, y, h_out, B, T, H, G, P, N, st);
    }
    return dispatch_p<__nv_bfloat16, float>(x, dt, a_log, bm, cm, h0, y, h_out, B, T, H,
                                            G, P, N, st);
  }
  return cudaErrorInvalidValue;
}
