// Causal sliding-window prefill attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/swa_prefill/swa_prefill.py
// swa_prefill_pallas (wrapper ops.py swa_prefill_attention): for each query
// position p, softmax(q_p . k_j * scale) over keys j with 0 <= p - j < window
// (scale D^-0.5 unless the caller gives one: zamba2-7b's is (D / 2)^-0.5),
// applied to V, with the online softmax in f32, masked probabilities set to
// zero, and out = acc / max(l, 1e-30).  Full causal attention is window >= S.
//
// Layouts (row-major, contiguous): q, out (B, S, H, D); k, v (B, S, KV, D);
// query head h reads KV head h / (H / KV) directly (the TPU wrapper repeats
// K/V over the GQA groups instead).  D in {16, 32, 64, 80, 128, 224, 256}, any
// S.
//
// Two kernels, split by the storage type:
//
// bf16 (the served type): a FlashAttention-2-style forward on the tensor
// cores (mma.sync.m16n8k16, bf16 inputs, f32 accumulators; mma.cuh).  One
// block per (query head, batch row, 64-row query tile), 4 warps of 16 query
// rows.  blockIdx.x is the query head, so the G heads that share a KV head
// run side by side and meet in L2 on its K/V tiles; blockIdx.z walks the
// query tiles from the last to the first over all batch rows, so every block
// with the longest key band starts in the first wave.  The block walks only
// the 64-key tiles that intersect [q0 - window + 1, q_last], keeping K and V
// in bf16 in shared memory in a ring of two stages: cp.async brings tile
// t + 1 while tile t is computed, with one barrier per tile.  Rows are
// padded by 16 bytes (pitch D + 8) so that ldmatrix is free of bank
// conflicts at every D, the 160-byte rows of D = 80 included.  At D <= 128
// each warp reads its Q rows once from global memory straight into A
// fragments; at D = 256 those fragments (64 registers a thread beside the
// 128 of the O accumulator) would not fit, so the block's 64 Q rows come
// into shared memory with the first K/V tile (at D = 224 too: 148,480 bytes in
// all, 14 k-steps and 28 output tiles) and each 16-wide k-step of
// Q K^T reads its A fragment there with ldmatrix; S =
// Q K^T reads K with ldmatrix; the row max is taken on the f32 scores and
// each score is scaled (D^-0.5 log2 e, never a bf16 q) in the multiply-add
// that feeds ex2.approx; masks are applied only on tiles that cross the
// causal or the window edge; the online softmax runs on the accumulator
// fragments (a row lives in the 4 lanes of a quad: 2 shuffles for its max,
// its sum is reduced once at the end); P is rounded to bf16 in registers
// and is the A operand of P V as it stands, V read with ldmatrix.trans.
// The output goes through shared memory and out as 16-byte stores.  Shared
// memory per block: 512 (D + 8) bytes (36,864 at D = 64, 45,056 at D = 80),
// and at D = 256 another 128 (D + 8) for Q (168,960 in all: one block per
// SM).  Registers are capped so that 4 blocks fit an SM at D <= 64 and 3 at
// D 80 and 128; at D = 256 one block may take up to 255 registers a thread.
// mma.sync and not wgmma: at the served shapes (S = 256, 144-512 blocks)
// latency bounds the kernel, not the tensor-core rate, and a 16-row warp
// tile keeps the causal tail short.
//
// f32 (full-width parity and the tests): the first port's kernel, unchanged,
// on the CUDA cores in full f32 (tensor cores would take f32 through TF32,
// about 1e-3 relative, above the repo's f32 tolerance of 2e-5).  One block
// per (64-row query tile, query head, batch row), 8 warps of 8 query rows;
// each 64-key tile of the band is staged in shared memory as f32 (K rows
// padded to D + 1 floats so that lane-per-key reads hit distinct banks), a
// warp scores two keys per lane, updates (m, l) with warp reductions and
// accumulates P.V with each lane owning ceil(D / 32) output columns.  D = 80
// needs 63,744 bytes of shared memory (D = 256: 198,912), above the 48 KB
// default, which launch() opts in to.
//
// What bounds it on the H100: at the served shapes the bytes and the
// operations of one call are small (chip_smoke.py computes the least time
// from each and measures the kernel beside them; PERF.md keeps the numbers),
// so the bf16 kernel is bound by latency: each warp's chain of key tiles
// (Q K^T, the softmax's 32 exponentials per lane, P V, each waiting on the
// last) when about one warp runs per scheduler, plus the load of the first
// tile.  At a 4096-token prompt the
// tensor cores' mma.sync rate and the K/V tiles re-read from L2 by every
// query tile do.
#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace repro_torch {
namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTile = 64;                    // query rows per block = keys per tile
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kTile / kWarps;

template <int D>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) * (kTile * D + kTile * (D + 1) + kTile * D + kWarps * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
swa_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   int S, int H, int KV, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int DPL = (D + 31) / 32;         // output columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;                         // [kTile][D], pre-scaled
  float* k_s = q_s + kTile * D;              // [kTile][DP]
  float* v_s = k_s + kTile * DP;             // [kTile][D]
  float* p_s = v_s + kTile * D;              // [kWarps][kTile]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q_last = min(q0 + kTile, S) - 1;

  // stage the q tile, scaled in f32 as the TPU kernel does
  for (int i = tid; i < kTile * D / 8; i += blockDim.x) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const int s = q0 + r;
    float x[8];
    if (s < S) {
      load8(q + ((static_cast<int64_t>(b) * S + s) * H + h) * D + c, x);
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) x[t] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) q_s[r * D + c + t] = x[t] * scale;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  const int k_first = max(0, q0 - window + 1);
  for (int k0 = (k_first / kTile) * kTile; k0 <= q_last; k0 += kTile) {
    __syncthreads();                         // the previous tile is consumed
    for (int i = tid; i < kTile * D / 8; i += blockDim.x) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      const int s = k0 + r;
      float kx[8], vx[8];
      if (s < S) {
        const int64_t off = ((static_cast<int64_t>(b) * S + s) * KV + kvh) * D + c;
        load8(k + off, kx);
        load8(v + off, vx);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) kx[t] = vx[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        k_s[r * DP + c + t] = kx[t];
        v_s[r * D + c + t] = vx[t];
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qpos = q0 + r;
      if (qpos < S) {                        // warp-uniform
        const float* qr = q_s + r * D;
        const float* ka = k_s + lane * DP;
        const float* kb = k_s + (lane + 32) * DP;
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float qd = qr[d];
          sa = fmaf(qd, ka[d], sa);
          sb = fmaf(qd, kb[d], sb);
        }
        // rel >= 0 implies the key lies before qpos < S
        const int rel_a = qpos - (k0 + lane);
        const int rel_b = rel_a - 32;
        const bool ok_a = rel_a >= 0 && rel_a < window;
        const bool ok_b = rel_b >= 0 && rel_b < window;
        sa = ok_a ? sa : kNegInf;
        sb = ok_b ? sb : kNegInf;
        const float m_new = fmaxf(m[rr], warp_max(fmaxf(sa, sb)));
        const float pa = ok_a ? expf(sa - m_new) : 0.f;
        const float pb = ok_b ? expf(sb - m_new) : 0.f;
        const float alpha = expf(m[rr] - m_new);
        l[rr] = l[rr] * alpha + warp_sum(pa + pb);
        m[rr] = m_new;
        float* pw = p_s + warp * kTile;
        pw[lane] = pa;
        pw[lane + 32] = pb;
        __syncwarp();
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            float a = acc[rr][i] * alpha;
#pragma unroll 8
            for (int j = 0; j < kTile; ++j) a = fmaf(pw[j], v_s[j * D + d], a);
            acc[rr][i] = a;
          }
        }
        __syncwarp();                        // pw is rewritten by the next row
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qpos = q0 + warp * kRowsPerWarp + rr;
    if (qpos < S) {
      const float denom = fmaxf(l[rr], 1e-30f);
      T* o = out + ((static_cast<int64_t>(b) * S + qpos) * H + h) * D;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) store(o + d, acc[rr][i] / denom);
      }
    }
  }
}

// the softmax scale of a call: the caller's (scale > 0) or D^-0.5
template <int D>
double softmax_scale(double scale) {
  return scale > 0 ? scale : 1.0 / std::sqrt(static_cast<double>(D));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int S, int H, int KV, int window, double scale, cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes<D>();
  static bool configured = false;            // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        swa_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  swa_prefill_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, KV, window, static_cast<float>(softmax_scale<D>(scale)));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBfRows = 64;                  // query rows per block, 16 per warp
constexpr int kBfKeys = 64;                  // keys per K/V tile
constexpr int kBfWarps = 4;
constexpr int kBfStages = 2;                 // K/V tiles in the shared-memory ring

// bf16 elements per shared-memory row: 16 bytes of padding put the 8 rows
// of one ldmatrix on 8 distinct groups of 4 banks at every D
template <int D>
__host__ __device__ constexpr int bf16_pitch() { return D + 8; }

// Q in shared memory (read per k-step with ldmatrix) instead of registers
template <int D>
__host__ __device__ constexpr bool q_in_smem() { return D > 128; }

// the ring of K and V tiles, then the block's Q rows where they are shared
template <int D>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * bf16_pitch<D>()
         * (2 * kBfStages * kBfKeys + (q_in_smem<D>() ? kBfRows : 0));
}

// blocks per SM the registers are capped for
template <int D>
__host__ __device__ constexpr int bf16_min_blocks() {
  return D <= 64 ? 4 : D <= 128 ? 3 : 1;
}

// rows [r0, r0 + 64) of one head (`stride` elements apart in src, r0 < S)
// into a [64][pitch] shared tile with 16-byte cp.async, each thread a fixed
// set of chunks (64 D / 8 is a multiple of the block's 128 threads at every
// D); rows at or past S are zeros
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int stride, int r0, int S) {
  constexpr int P = bf16_pitch<D>();
  constexpr int kChunks = D / 8;
  constexpr int kPer = kBfKeys * kChunks / (kBfWarps * 32);
  static_assert(kBfKeys * kChunks % (kBfWarps * 32) == 0, "chunks per thread");
  const __nv_bfloat16* base = src + static_cast<int64_t>(r0) * stride;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = threadIdx.x + j * kBfWarps * 32;
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * P + col, base + (ok ? r * stride + col : 0), ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kBfWarps * 32, bf16_min_blocks<D>())
swa_prefill_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out, int S, int H, int KV,
                        int window, float scale_log2) {
  constexpr int P = bf16_pitch<D>();
  constexpr int KS = D / 16;                 // 16-wide steps of Q K^T over D
  constexpr int NT = D / 8;                  // 8-column tiles of the output
  constexpr int kTileElems = kBfKeys * P;
  constexpr bool kQShared = q_in_smem<D>();
  extern __shared__ __align__(16) unsigned char bf16_smem[];
  // stage i of the ring: K at k_s + i * kTileElems, V at v_s + i * kTileElems
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(bf16_smem);
  __nv_bfloat16* v_s = k_s + kBfStages * kTileElems;
  __nv_bfloat16* q_s = v_s + kBfStages * kTileElems;  // [64][P], kQShared only

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBfRows;  // longest bands first
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int q_last = min(q0 + kBfRows, S) - 1;
  const int t_first = max(0, q0 - window + 1) / kBfKeys;
  const int t_last = q_last / kBfKeys;

  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int kv_stride = KV * D;
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * S * H + h) * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * S * KV + kvh) * D;
  const __nv_bfloat16* kb = k + kv_off;
  const __nv_bfloat16* vb = v + kv_off;

  // the first kBfStages - 1 tiles of the band, one commit group each (an
  // empty group past the band keeps the count uniform); shared Q rows join
  // the first group
  if constexpr (kQShared) load_tile<D>(q_s, qb, H * D, q0, S);
#pragma unroll
  for (int i = 0; i < kBfStages - 1; ++i) {
    const int t = t_first + i;
    if (t <= t_last) {
      load_tile<D>(k_s + i * kTileElems, kb, kv_stride, t * kBfKeys, S);
      load_tile<D>(v_s + i * kTileElems, vb, kv_stride, t * kBfKeys, S);
    }
    cp_async_commit();
  }

  // Q's A fragments straight from global memory (each row once, while the
  // first tiles are in flight); rows past S are zeros
  const int w0 = q0 + warp * 16;             // the warp's first query row
  const int row0 = w0 + gid;                 // row of c[0..1]; c[2..3]: row0 + 8
  uint32_t qf[kQShared ? 1 : KS][4];
  if constexpr (!kQShared) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const uint32_t* qr = reinterpret_cast<const uint32_t*>(qb + row * q_stride) + tig;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        qf[ks][i] = row < S ? __ldg(qr + ks * 8) : 0u;
        qf[ks][i + 2] = row < S ? __ldg(qr + ks * 8 + 4) : 0u;
      }
    }
  }
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                   // this lane's share of the row sums

  for (int t = t_first; t <= t_last; ++t) {
    const int i = t - t_first;
    cp_async_wait<kBfStages - 2>();          // this thread's copies of tile t
    __syncthreads();                         // everyone's; tile t - 1 is consumed
    {                                        // tile t + kBfStages - 1 into its stage
      const int tn = t + kBfStages - 1;
      const int st = (i + kBfStages - 1) % kBfStages;
      if (tn <= t_last) {
        load_tile<D>(k_s + st * kTileElems, kb, kv_stride, tn * kBfKeys, S);
        load_tile<D>(v_s + st * kTileElems, vb, kv_stride, tn * kBfKeys, S);
      }
      cp_async_commit();
    }
    const int k0 = t * kBfKeys;
    // warp-uniform: some (row, key) pair of the warp's rows and this tile
    // passes the mask
    if (k0 <= w0 + 15 && k0 + kBfKeys - 1 >= w0 - window + 1) {
      const __nv_bfloat16* kt = k_s + (i % kBfStages) * kTileElems;
      const __nv_bfloat16* vt = v_s + (i % kBfStages) * kTileElems;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4];                      // Q rows w0..w0+15, columns 16 ks..
        if constexpr (kQShared) {
          ldmatrix_x4(qa, q_s + (warp * 16 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[ks][e];
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {     // 16 keys: two 8-key tiles
          uint32_t kf[4];
          ldmatrix_x4(kf, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * P
                              + ks * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[2 * np], qa, kf[0], kf[1]);
          mma_bf16_16816(s[2 * np + 1], qa, kf[2], kf[3]);
        }
      }
      // masks only where the tile crosses the causal or the window edge; a
      // masked score is -inf, so its probability is 0 while m stays >= -1e30.
      // m is kept scaled (by D^-0.5 log2 e) and the f32 scores are scaled in
      // the exponent's multiply-add; the max of a row is taken unscaled.
      if (!(k0 + kBfKeys - 1 <= w0 && w0 + 15 - k0 < window)) {
        const int rel0 = row0 - k0 - 2 * tig;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rel = rel0 + (e >> 1) * 8 - 8 * j - (e & 1);
            if (rel < 0 || rel >= window) s[j][e] = neg_inf();
          }
        }
      }
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * scale_log2);
        alpha[i] = fast_exp2(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(s[j][e], scale_log2, -m[e >> 1]));
          s[j][e] = p;
          l[e >> 1] += p;
        }
      }
      // P V: the probabilities of 16 keys (two score tiles) are one A
      // fragment as they stand
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {  // 16 columns: two 8-column tiles
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P
                                    + dp * 16 + (lane >> 4) * 8);
          mma_bf16_16816(o[2 * dp], pa, vf[0], vf[1]);
          mma_bf16_16816(o[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

  // the warp's 16 x D outputs go through shared memory (the ring is free
  // once every warp is past its last tile) and out as 16-byte stores
  __syncthreads();
  __nv_bfloat16* stage = k_s + warp * 16 * P;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(stage + (gid + 8 * i) * P + 8 * n + 2 * tig) =
          pack_bf16x2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {         // 16 rows of D / 8 chunks, 32 lanes
    const int c = lane + 32 * j;
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    if (w0 + r < S) {
      *reinterpret_cast<uint4*>(out + ((static_cast<int64_t>(b) * S + w0 + r) * H + h) * D
                                + col) = *reinterpret_cast<const uint4*>(stage + r * P + col);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                        int S, int H, int KV, int window, double scale,
                        cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<D>();
  static bool configured = false;            // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        swa_prefill_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(H, B, (S + kBfRows - 1) / kBfRows);
  swa_prefill_bf16_kernel<D><<<grid, kBfWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, H, KV,
      window, static_cast<float>(softmax_scale<D>(scale) * kLog2e));
  return cudaGetLastError();
}

// the storage type picks the kernel: bf16 the tensor cores, f32 the CUDA cores
template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* out, int B,
                         int S, int H, int KV, int window, double scale,
                         cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_bf16<D>(q, k, v, out, B, S, H, KV, window, scale, stream);
  } else {
    return launch<T, D>(q, k, v, out, B, S, H, KV, window, scale, stream);
  }
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
                       int S, int H, int KV, int D, int window, double sc,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch_typed<T, 16>(q, k, v, out, B, S, H, KV, window, sc, stream);
    case 32: return launch_typed<T, 32>(q, k, v, out, B, S, H, KV, window, sc, stream);
    case 64: return launch_typed<T, 64>(q, k, v, out, B, S, H, KV, window, sc, stream);
    case 80: return launch_typed<T, 80>(q, k, v, out, B, S, H, KV, window, sc, stream);
    case 128: return launch_typed<T, 128>(q, k, v, out, B, S, H, KV, window, sc, stream);
    case 224: return launch_typed<T, 224>(q, k, v, out, B, S, H, KV, window, sc, stream);
    case 256: return launch_typed<T, 256>(q, k, v, out, B, S, H, KV, window, sc, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  scale: the softmax scale, or <= 0 for
// D^-0.5.  Returns the cudaError_t of the launch.
extern "C" int repro_swa_prefill(const void* q, const void* k, const void* v, void* out,
                                 int B, int S, int H, int KV, int D, int window,
                                 double scale, int dtype, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(q, k, v, out, B, S, H, KV, D, window, scale, st);
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, H, KV, D, window, scale, st);
  }
  return cudaErrorInvalidValue;
}
