// The decode step's weight products, y = x @ W at a few rows, hand-written
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference leaves every weight product to XLA's
// dot (src/repro/models/common.py `linear`).  The port's prefill and forward
// keep that product on cuBLAS (models/common.py `linear`); this kernel takes
// the products of a decode step at B <= 16 rows, where cuBLAS runs skinny
// tiles and, for most shapes, a second split-K reduction kernel.
//
// y_s = x @ W_s for up to three weights W_s that read the same x (B, K) bf16:
// the segments of one product (a Mamba2 layer's z|x, B|C and dt
// in-projections are one launch).  W_s is (K, N_s) row-major (the port's
// (in, out) layout) or, with `wt`, one weight given as (N, K) row-major (the
// tied head, the embedding read in place).  Each y_s (B, N_s) bf16 has its own
// pointer and row stride.  Every output is a sum over K in f32, rounded once.
// K, N_s, the row strides multiples of 8 and every pointer 16-byte aligned
// (ops.py checks).
//
// What bounds it on the H100: the weight bytes.  At B <= 16 a product does at
// most 16 operations a weight byte, far below the card's 295, so the only
// gain is to stream each weight byte once near the 3.35 TB/s of HBM, in one
// launch.  The design:
//
// - A block owns a tile of BN output columns (128 of a (K, N) weight, 64 of
//   an (N, K) one) and a range of K.  Its 4 warps each take BN / 4 of
//   the columns over the whole tile depth: mma.sync.m16n8k16 with the weight
//   as the A operand (16 columns x 16 of K; ldmatrix.trans from the (K, N)
//   tile, plain ldmatrix from an (N, K) tile) and the rows of x as the n
//   dimension, one n-8 tile for B <= 8 and two for B <= 16.
// - The weight streams through a ring of 6 stages in shared memory, each 16 KB
//   of weight (BK = 8192 / BN rows of K, so a row of the tile is BN x 2
//   contiguous bytes of the weight) and the matching rows of x, filled by
//   16-byte cp.async copies: 5 stages (80 KB) are in flight while one is
//   multiplied.  The weight's 16-byte chunks are swizzled by the row (chunk ^
//   row % 8) and x's rows padded by 16 bytes, so ldmatrix reads both without
//   bank conflicts.  Rows past K and columns past N_s are zero-filled.
// - Where the tiles alone would leave SMs idle (N = 3584 gives 28 tiles for
//   132 SMs), K is split over the `split` blocks of a thread-block cluster
//   (ops.py `split_for`): each takes a contiguous range of the stages, and
//   after cluster.sync() each block adds a share of the tile's outputs over
//   the cluster's partial sums in distributed shared memory, in rank order,
//   and rounds once.  A second cluster.sync() keeps every block's shared
//   memory alive until the others have read it.  One launch, no scratch
//   tensor, no atomics.
// - Launched as a programmatic dependent launch (common.cuh): the weight
//   bytes of the first stages are requested before wait_for_prior_grid(),
//   so they stream while the kernel before it in the stream finishes (the
//   small fused kernels let it start at their top); x is read and y written
//   only after the wait.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace repro_torch {
namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSeg = 3;
constexpr int kMaxSplit = 8;                 // blocks per cluster: the portable maximum
constexpr int kWeightElems = 8192;           // 16 KB of weight a stage
constexpr int kStages = 6;                   // a ring of 102-124 KB: two blocks an SM
                                             // but at B > 8 with 64 columns
constexpr int kTile = 128;                   // output columns a block of a (K, N) weight
constexpr int kTileT = 64;                   // and of an (N, K) one (ops.py TILE_N)

struct Segments {
  const __nv_bfloat16* w[kMaxSeg];
  long long ldw[kMaxSeg];
  __nv_bfloat16* y[kMaxSeg];
  long long ldy[kMaxSeg];
  int n[kMaxSeg];
  int tile_end[kMaxSeg];                     // the segments' tiles, running total
  int count;
};

// element s of a parameter array, without indexing it at run time (which
// would copy the kernel's parameters to local memory)
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxSeg], int s) {
  return s == 0 ? a[0] : (s == 1 ? a[1] : a[2]);
}

// ROWS (8 or 16) rows of x; WT: the weight is given as (N, K); BN output
// columns and BK rows of K a stage
template <int ROWS, bool WT, int BN>
struct Tile {
  static constexpr int BK = kWeightElems / BN;
  static constexpr int XP = BK + 8;          // x's padded row
  static constexpr int kStageElems = kWeightElems + ROWS * XP;
  static constexpr int kSmemBytes = kStages * kStageElems * 2;
  static constexpr int MT = BN / (16 * kWarps);   // 16-column A tiles a warp
};

// chunk c of row r of a shared tile whose rows hold `chunks` 16-byte chunks
// sits at chunk c ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c, int chunks) {
  return r * chunks * 8 + ((c ^ (r & 7)) * 8);
}

template <int ROWS, bool WT, int BN>
__device__ __forceinline__ void load_weight(__nv_bfloat16* st, int K,
                                            const __nv_bfloat16* __restrict__ w, long long ldw,
                                            int n, int n0, int k0) {
  using T = Tile<ROWS, WT, BN>;
#pragma unroll
  for (int i = 0; i < kWeightElems / 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if constexpr (!WT) {
      // (K, N): BK rows of BN / 8 chunks
      const int r = idx / (BN / 8), c = idx % (BN / 8);
      const int k = k0 + r, col = n0 + 8 * c;
      const bool ok = k < K && col < n;
      const __nv_bfloat16* src = ok ? w + static_cast<long long>(k) * ldw + col : w;
      cp_async16(st + swz(r, c, BN / 8), src, ok ? 16 : 0);
    } else {
      // (N, K): BN rows of BK / 8 chunks
      const int r = idx / (T::BK / 8), c = idx % (T::BK / 8);
      const int col = n0 + r, k = k0 + 8 * c;
      const bool ok = k < K && col < n;
      const __nv_bfloat16* src = ok ? w + static_cast<long long>(col) * ldw + k : w;
      cp_async16(st + swz(r, c, T::BK / 8), src, ok ? 16 : 0);
    }
  }
}

template <int ROWS, bool WT, int BN>
__device__ __forceinline__ void load_x(__nv_bfloat16* st, const __nv_bfloat16* __restrict__ x,
                                       long long ldx, int B, int K, int k0) {
  using T = Tile<ROWS, WT, BN>;
  __nv_bfloat16* xs = st + kWeightElems;
  constexpr int kChunks = ROWS * T::BK / 8;
#pragma unroll
  for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < kChunks) {
      const int r = idx / (T::BK / 8), c = idx % (T::BK / 8);
      const int k = k0 + 8 * c;
      const bool ok = r < B && k < K;
      cp_async16(xs + r * T::XP + 8 * c, ok ? x + r * ldx + k : x, ok ? 16 : 0);
    }
  }
}

template <int ROWS, bool WT, int BN>
__device__ __forceinline__ void multiply_stage(const __nv_bfloat16* st,
                                               float (&acc)[BN / 64][ROWS / 8][4]) {
  using T = Tile<ROWS, WT, BN>;
  const __nv_bfloat16* xs = st + kWeightElems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = lane >> 3, i = lane & 7;
#pragma unroll
  for (int ks = 0; ks < T::BK / 16; ++ks) {
    // B: rows 8 (j / 2) + i of x, columns 16 ks + 8 (j % 2); with 8 rows
    // lanes 0-15 address the two matrices of the one n-8 tile
    uint32_t b[4];
    if constexpr (ROWS == 8) {
      uint32_t b2[2];
      ldmatrix_x2(b2, xs + i * T::XP + 16 * ks + 8 * (j & 1));
      b[0] = b2[0];
      b[1] = b2[1];
    } else {
      ldmatrix_x4(b, xs + (8 * (j >> 1) + i) * T::XP + 16 * ks + 8 * (j & 1));
    }
#pragma unroll
    for (int m = 0; m < T::MT; ++m) {
      // A: matrix j holds columns 16 (warp MT + m) + 8 (j % 2) and rows of K
      // 16 ks + 8 (j / 2)
      const int col16 = warp * T::MT + m;
      uint32_t a[4];
      if constexpr (!WT) {
        const int r = 16 * ks + 8 * (j >> 1) + i;
        ldmatrix_x4_trans(a, st + swz(r, 2 * col16 + (j & 1), BN / 8));
      } else {
        const int r = 16 * col16 + 8 * (j & 1) + i;
        ldmatrix_x4(a, st + swz(r, 2 * ks + (j >> 1), T::BK / 8));
      }
      mma_bf16_16816(acc[m][0], a, b[0], b[1]);
      if constexpr (ROWS == 16) mma_bf16_16816(acc[m][1], a, b[2], b[3]);
    }
  }
}

template <int ROWS, bool WT, int BN>
__global__ void __launch_bounds__(kThreads)
    decode_gemm_kernel(const __nv_bfloat16* __restrict__ x, long long ldx, int B, int K,
                       Segments seg) {
  using T = Tile<ROWS, WT, BN>;
  extern __shared__ __align__(128) __nv_bfloat16 smem[];
  allow_next_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  // the block's segment and its BN columns
  const int tile = blockIdx.y;
  int s = 0;
#pragma unroll
  for (int q = 0; q < kMaxSeg - 1; ++q) s += (q < seg.count - 1 && tile >= seg.tile_end[q]);
  const int n0 = (tile - (s > 0 ? pick(seg.tile_end, s - 1) : 0)) * BN;
  const __nv_bfloat16* w = pick(seg.w, s);
  const long long ldw = pick(seg.ldw, s);
  const int n = pick(seg.n, s);

  // this block's stages of K: a contiguous share of ceil(K / BK)
  const int stages = (K + T::BK - 1) / T::BK;
  const int first = rank * stages / split, last = (rank + 1) * stages / split;
  const int count = last - first;

  float acc[T::MT][ROWS / 8][4];
#pragma unroll
  for (int m = 0; m < T::MT; ++m)
#pragma unroll
    for (int t = 0; t < ROWS / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;

  // the weight of the first stages before the wait (it depends on no
  // kernel), x after it; stage p's copies complete with commit group p
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < count) {
      load_weight<ROWS, WT, BN>(smem + p * T::kStageElems, K, w, ldw, n, n0,
                                (first + p) * T::BK);
    }
  }
  wait_for_prior_grid();
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < count) {
      load_x<ROWS, WT, BN>(smem + p * T::kStageElems, x, ldx, B, K, (first + p) * T::BK);
    }
    cp_async_commit();
  }
  for (int it = 0; it < count; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                         // stage `it` landed; stage it - 1 consumed
    const int next = it + kStages - 1;
    if (next < count) {
      __nv_bfloat16* st = smem + (next % kStages) * T::kStageElems;
      const int k0 = (first + next) * T::BK;
      load_weight<ROWS, WT, BN>(st, K, w, ldw, n, n0, k0);
      load_x<ROWS, WT, BN>(st, x, ldx, B, K, k0);
    }
    cp_async_commit();
    multiply_stage<ROWS, WT, BN>(smem + (it % kStages) * T::kStageElems, acc);
  }

  // acc[m][t]: c[0..1] column 16 (warp MT + m) + gid, rows 8 t + 2 tig..+1;
  // c[2..3] column + 8
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  __nv_bfloat16* y = pick(seg.y, s);
  const long long ldy = pick(seg.ldy, s);
  if (split == 1) {
#pragma unroll
    for (int m = 0; m < T::MT; ++m)
#pragma unroll
      for (int t = 0; t < ROWS / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 16 * (warp * T::MT + m) + gid + 8 * (e >> 1);
          const int row = 8 * t + 2 * tig + (e & 1);
          if (row < B && col < n) y[row * ldy + col] = __float2bfloat16(acc[m][t][e]);
        }
    return;
  }
  // the block's sums, [column][row] in f32, where the ring was
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < T::MT; ++m)
#pragma unroll
    for (int t = 0; t < ROWS / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 16 * (warp * T::MT + m) + gid + 8 * (e >> 1);
        part[col * ROWS + 8 * t + 2 * tig + (e & 1)] = acc[m][t][e];
      }
  cluster.sync();
  // block `rank` sums its runs of 128 outputs (runs rank, rank + split, ...)
  // over the cluster
  for (int o = rank * kThreads + threadIdx.x; o < BN * B; o += split * kThreads) {
    const int col = o / B, row = o - col * B;
    float v = 0.f;
    for (int r = 0; r < split; ++r) v += *cluster.map_shared_rank(&part[col * ROWS + row], r);
    if (n0 + col < n) y[row * ldy + n0 + col] = __float2bfloat16(v);
  }
  cluster.sync();                            // every block has read the others
}

template <int ROWS, bool WT, int BN>
cudaError_t launch(const void* x, long long ldx, int B, int K, const Segments& seg, int split,
                   cudaStream_t stream) {
  using T = Tile<ROWS, WT, BN>;
  static bool opted = false;                 // the dynamic shared memory opt-in, once
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(decode_gemm_kernel<ROWS, WT, BN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               T::kSmemBytes);
    if (e != cudaSuccess) return e;
    opted = true;
  }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;   // common.cuh
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, seg.tile_end[seg.count - 1]);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_gemm_kernel<ROWS, WT, BN>,
                                           static_cast<const __nv_bfloat16*>(x), ldx, B, K, seg);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int ROWS>
cudaError_t launch_rows(const void* x, long long ldx, int B, int K, const Segments& seg,
                        int split, int wt, cudaStream_t st) {
  if (wt) return launch<ROWS, true, kTileT>(x, ldx, B, K, seg, split, st);
  return launch<ROWS, false, kTile>(x, ldx, B, K, seg, split, st);
}

}  // namespace
}  // namespace repro_torch

// x (B, K) bf16 with row stride ldx; `count` weights w_s with row stride ldw_s
// and N_s columns, each into y_s (B, N_s) with row stride ldy_s; wt: the one
// weight is given as (N, K).  split: the blocks of a cluster over K (1..8).
// Returns the cudaError_t of the launch.
extern "C" int repro_decode_gemm(const void* x, long long ldx, int B, int K, int count,
                                 const void* w0, long long ldw0, int n0, void* y0,
                                 long long ldy0, const void* w1, long long ldw1, int n1,
                                 void* y1, long long ldy1, const void* w2, long long ldw2,
                                 int n2, void* y2, long long ldy2, int wt, int split,
                                 void* stream) {
  using namespace repro_torch;
  if (B < 1 || B > 16 || K < 1 || count < 1 || count > kMaxSeg || split < 1 ||
      split > kMaxSplit || (wt && count != 1)) {
    return cudaErrorInvalidValue;
  }
  Segments seg = {};
  const void* ws[kMaxSeg] = {w0, w1, w2};
  void* ys[kMaxSeg] = {y0, y1, y2};
  const long long ldws[kMaxSeg] = {ldw0, ldw1, ldw2};
  const long long ldys[kMaxSeg] = {ldy0, ldy1, ldy2};
  const int ns[kMaxSeg] = {n0, n1, n2};
  const int bn = wt ? kTileT : kTile;
  int tiles = 0;
  for (int s = 0; s < count; ++s) {
    if (ns[s] < 1) return cudaErrorInvalidValue;
    seg.w[s] = static_cast<const __nv_bfloat16*>(ws[s]);
    seg.y[s] = static_cast<__nv_bfloat16*>(ys[s]);
    seg.ldw[s] = ldws[s];
    seg.ldy[s] = ldys[s];
    seg.n[s] = ns[s];
    tiles += (ns[s] + bn - 1) / bn;
    seg.tile_end[s] = tiles;
  }
  seg.count = count;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 8) return launch_rows<8>(x, ldx, B, K, seg, split, wt, st);
  return launch_rows<16>(x, ldx, B, K, seg, split, wt, st);
}
