// Grouped matrix products on Hopper (sm_90a): the dropless MoE layer's
// expert projections, forward and backward.
//
// Replaces the two Pallas TPU kernels of megablox (installed JAX,
// jax/experimental/pallas/ops/tpu/megablox/gmm.py), which the JAX package
// reaches from flashy_tpu/parallel/moe_ep.py `_grouped_mlp` and through
// the custom VJP of megablox/ops.py (`_gmm_bwd`):
//   * flashy_gmm   <- `gmm` (pallas_call at gmm.py:526): out[rows of g] =
//     lhs[rows of g] . rhs[g], lhs [M, K], rhs [E, K, N], out [M, N];
//   * flashy_gmm_t <- `gmm` with transpose_rhs=True: rhs [E, N, K], out
//     [rows of g] = lhs[rows of g] . rhs[g]^T (the input gradient);
//   * flashy_tgmm  <- `tgmm` (pallas_call at gmm.py:763): out[g] =
//     lhs[rows of g]^T . rhs[rows of g], lhs [M, K], rhs [M, N], out
//     [E, K, N] (the weight gradient). lhs is read as it lies, [M, K],
//     and contracted over its rows: no transposed copy is made.
// Group g owns rows [offset_g, offset_g + group_sizes[g]) (prefix sums in
// group order, clamped to M). Rows of gmm past the last group come out
// as zeros; a tgmm group with no rows gives exact zeros, as megablox's
// `_zero_uninitialized_memory` and its empty-group visits ensure.
//
// What each computes is what the Pallas bodies compute: an f32
// accumulator per output tile over the whole contraction, cast to the
// output dtype once at the end. Types follow megablox's
// `select_input_dtype`: two bf16 operands multiply as bf16 on the tensor
// cores (`mma.sync` m16n8k16, f32 accumulation; bf16 products are exact
// in f32, so only the order of the f32 sums differs from the plain
// version); any f32 operand makes the product f32, run here as explicit
// fmaf in ascending contraction order (no TF32).
//
// Group edges. The TPU kernel's grid walks (group, row tile) visits from
// scalar-prefetched metadata (`make_group_metadata`, gmm.py:79) and masks
// its store to the visit's rows (`_get_store_mask`). Here the group sizes
// stay on the device: each block of gmm / gmm_t reads them, takes its
// visit from the prefix sums (a tile that straddles a group edge is
// visited once by each group, a visit never stores a row of another
// group) and masks both the rows it loads (zero-filled) and the rows it
// stores. The grid is sized without looking at the sizes, from the bound
// ceil(M / 128) + E visits (each group edge adds at most one partial
// tile, the rows past the groups one more); blocks past the last visit
// exit. No host synchronisation is needed. tgmm runs one block per
// (output tile, group), loops over that group's rows from its first row,
// and zero-fills rows past the group's end, so no row of the group is
// dropped and none of another group enters.
//
// What bounds it on this card: operations. At the training shapes
// (32768 routed rows, dim 1024, hidden 4096) each launch does 275 GFLOP
// against well under 1 GB: ~0.28 ms at the 989 TFLOP/s bf16 peak for
// two bf16 operands, ~4.1 ms at the 67 TFLOP/s f32 peak once an operand
// is f32 (the gradient of the second projection, which megablox computes
// in f32). The design's answer is the simple tiled product: 128 x 128
// output tiles on 256 threads, the tensor-core route fed by a 3-stage
// cp.async ring of bf16 tiles (16-byte copies, zero-filled at every
// edge) read with ldmatrix, the f32 route by 16-deep register-staged
// tiles widened to f32 in shared memory (16-byte global loads), 8 x 8
// outputs a thread. wgmma, TMA, a persistent scheduler and a split-bf16
// product for the f32 operand are later work (ROADMAP.md queue B); the
// times beside the bounds are in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 128;          // output tile rows
constexpr int kBN = 128;          // output tile columns
constexpr int kMmaBK = 32;        // contraction depth of a tensor-core stage
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kFmaBK = 16;        // contraction depth of an f32 stage
constexpr int kFmaLd = kBM + 4;   // padded f32 tile row (16-byte aligned)

enum Layout { kNN = 0, kNT = 1, kTN = 2 };

struct Args {
  const void* lhs;
  const void* rhs;
  const int* sizes;   // [E] int32 group sizes, on the device
  void* out;
  int M, K, N, E;
  int out_bf16;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------
// which rows a block owns
// ---------------------------------------------------------------------

// gmm / gmm_t: visit v -> (group, tile). A non-empty group visits every
// kBM-row tile its rows touch, in group order; after the groups, the
// rows [total, M) are visited as group -1 (written as zeros). Returns
// false for blocks past the last visit.
__device__ bool find_visit(const int* sizes, int E, int M, int v, int* group,
                           int* row0, int* lo, int* hi) {
  long long start = 0;
  int seen = 0;
  for (int g = 0; g <= E; ++g) {
    const long long end =
        g < E ? min(start + max(sizes[g], 0), static_cast<long long>(M))
              : static_cast<long long>(M);
    if (end > start) {
      const int first = static_cast<int>(start / kBM);
      const int count = static_cast<int>((end - 1) / kBM) - first + 1;
      if (v < seen + count) {
        *group = g < E ? g : -1;
        *row0 = (first + v - seen) * kBM;
        *lo = max(static_cast<int>(start), *row0);
        *hi = min(static_cast<int>(end), *row0 + kBM);
        return true;
      }
      seen += count;
    }
    start = end;
  }
  return false;
}

// tgmm: the rows [lo, hi) of group g
__device__ void group_rows(const int* sizes, int g, int M, int* lo, int* hi) {
  long long start = 0;
  for (int i = 0; i < g; ++i) start += max(sizes[i], 0);
  start = min(start, static_cast<long long>(M));
  *lo = static_cast<int>(start);
  *hi = static_cast<int>(
      min(start + max(sizes[g], 0), static_cast<long long>(M)));
}

// zeros into rows [r_lo, r_hi) x columns [n0, n0 + kBN) of a row-major
// [*, N] output whose row r starts at element (row_base + r) * N
__device__ void store_zeros(void* out, int out_bf16, long long row_base,
                            int r_lo, int r_hi, int n0, int N) {
  constexpr int kQuads = kBN / 4;
  const int rows = r_hi - r_lo;
  for (int i = threadIdx.x; i < rows * kQuads; i += kThreads) {
    const int c = n0 + (i % kQuads) * 4;
    if (c >= N) continue;
    const long long at = (row_base + r_lo + i / kQuads) * N + c;
    if (out_bf16)
      *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + at) =
          make_uint2(0u, 0u);
    else
      *reinterpret_cast<float4*>(static_cast<float*>(out) + at) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ---------------------------------------------------------------------
// tensor-core route: bf16 x bf16, f32 accumulation
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool copy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(copy ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy a ROWS x COLS tile of a row-major bf16 matrix (leading dimension
// ld, top-left element (row0, col0)) into shared memory with leading
// dimension LD, 16 bytes per cp.async. Rows outside [lo, hi) and
// columns at or past `cols` are zero-filled and never read.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long ld, int row0,
                                                int lo, int hi, int col0,
                                                int cols) {
  constexpr int kChunks = COLS / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "tile is not whole chunks");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, cc = (c % kChunks) * 8;
    const int gr = row0 + r, gc = col0 + cc;
    const bool ok = gr >= lo && gr < hi && gc < cols;
    cp_async16(dst + r * LD + cc, ok ? src + gr * ld + gc : src, ok);
  }
}

// Shared-memory tiles of the tensor-core route. The product is
// C (m x n) = A (m x k) B (k x n). A is stored as loaded: k-major
// [kBM][kMmaBK + 8] when lhs rows are the m rows (gmm, gmm_t), m-major
// [kMmaBK][kBM + 8] when the contraction runs over lhs rows (tgmm). B is
// n-major [kMmaBK][kBN + 8] (gmm: rhs[g] is [K, N]; tgmm: rhs is
// [M, N]) or k-major [kBN][kMmaBK + 8] (gmm_t: rhs[g] is [N, K]). The 8
// elements of padding make every ldmatrix phase hit 8 distinct 16-byte
// bank groups (rows 80 or 272 bytes apart).
template <int L>
struct MmaTiles {
  static constexpr bool kAKMajor = L != kTN;
  static constexpr bool kBKMajor = L == kNT;
  static constexpr int kALd = kAKMajor ? kMmaBK + 8 : kBM + 8;
  static constexpr int kBLd = kBKMajor ? kMmaBK + 8 : kBN + 8;
  static constexpr int kA = (kAKMajor ? kBM : kMmaBK) * kALd;
  static constexpr int kB = (kBKMajor ? kBN : kMmaBK) * kBLd;
  static constexpr size_t kSmem = kStages * (kA + kB) * sizeof(bf16);
};

template <int L>
__global__ void __launch_bounds__(kThreads)
    grouped_mma_kernel(const Args a) {
  using S = MmaTiles<L>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + kStages * S::kA;
  const bf16* lhs = static_cast<const bf16*>(a.lhs);
  const bf16* rhs = static_cast<const bf16*>(a.rhs);
  const int n0 = blockIdx.x * kBN;

  // the block's tile: m0 is its first output row (gmm: an lhs row;
  // tgmm: a column of lhs); [lo, hi) the rows it owns (gmm: rows of the
  // tile in its group; tgmm: the group's rows, the contraction)
  int group, m0, lo, hi;
  if constexpr (L == kTN) {
    group = blockIdx.z;
    m0 = blockIdx.y * kBM;
    group_rows(a.sizes, group, a.M, &lo, &hi);
    if (hi <= lo) {
      store_zeros(a.out, a.out_bf16, static_cast<long long>(group) * a.K, m0,
                  min(m0 + kBM, a.K), n0, a.N);
      return;
    }
  } else {
    if (!find_visit(a.sizes, a.E, a.M, blockIdx.y, &group, &m0, &lo, &hi))
      return;
    if (group < 0) {
      store_zeros(a.out, a.out_bf16, 0, lo, hi, n0, a.N);
      return;
    }
    rhs += static_cast<long long>(group) * a.K * a.N;
  }
  const int depth = L == kTN ? hi - lo : a.K;
  const int steps = (depth + kMmaBK - 1) / kMmaBK;

  auto load_stage = [&](int step, int stage) {
    bf16* as = As + stage * S::kA;
    bf16* bs = Bs + stage * S::kB;
    const int k0 = step * kMmaBK;
    if constexpr (L == kTN) {
      load_tile_async<kMmaBK, kBM, S::kALd>(as, lhs, a.K, lo + k0, lo, hi, m0,
                                            a.K);
      load_tile_async<kMmaBK, kBN, S::kBLd>(bs, rhs, a.N, lo + k0, lo, hi, n0,
                                            a.N);
    } else {
      load_tile_async<kBM, kMmaBK, S::kALd>(as, lhs, a.K, m0, lo, hi, k0,
                                            a.K);
      if constexpr (L == kNN)
        load_tile_async<kMmaBK, kBN, S::kBLd>(bs, rhs, a.N, k0, 0, a.K, n0,
                                              a.N);
      else
        load_tile_async<kBN, kMmaBK, S::kBLd>(bs, rhs, a.K, n0, 0, a.N, k0,
                                              a.K);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int mat = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, its row
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage landed; every warp left the one refilled
    const int next = step + kStages - 1;
    if (next < steps) load_stage(next, next % kStages);
    cp_async_commit();
    const bf16* as = As + (step % kStages) * S::kA;
    const bf16* bs = Bs + (step % kStages) * S::kB;
#pragma unroll
    for (int ks = 0; ks < kMmaBK; ks += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mb = wm * 64 + i * 16;
        if constexpr (S::kAKMajor)
          ldsm_x4(af[i], as + (mb + (mat & 1) * 8 + mr) * S::kALd + ks +
                             (mat >> 1) * 8);
        else
          ldsm_x4_t(af[i], as + (ks + (mat >> 1) * 8 + mr) * S::kALd + mb +
                               (mat & 1) * 8);
      }
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        const int nb = wn * 32 + j2 * 16;
        uint32_t r[4];
        if constexpr (S::kBKMajor)
          ldsm_x4(r, bs + (nb + (mat >> 1) * 8 + mr) * S::kBLd + ks +
                         (mat & 1) * 8);
        else
          ldsm_x4_t(r, bs + (ks + (mat & 1) * 8 + mr) * S::kBLd + nb +
                           (mat >> 1) * 8);
        bfr[2 * j2][0] = r[0];
        bfr[2 * j2][1] = r[1];
        bfr[2 * j2 + 1][0] = r[2];
        bfr[2 * j2 + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

  // the m16n8 fragments: (row g, cols 2t, 2t+1) and (row g + 8, same)
  const int g = lane >> 2, t = lane & 3;
  const long long row_base = L == kTN ? static_cast<long long>(group) * a.K
                                      : 0;
  const int row_lo = L == kTN ? 0 : lo;
  const int row_hi = L == kTN ? a.K : hi;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + i * 16 + g + half * 8;
      if (row < row_lo || row >= row_hi) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        if (col >= a.N) continue;
        const long long at = (row_base + row) * a.N + col;
        const float x = acc[i][j][2 * half], y = acc[i][j][2 * half + 1];
        if (a.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + at) =
              __floats2bfloat162_rn(x, y);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at) =
              make_float2(x, y);
      }
    }
  }
}

// ---------------------------------------------------------------------
// f32 route: any f32 operand, explicit fmaf in ascending order
// ---------------------------------------------------------------------

// A ROWS x COLS tile of a row-major matrix of T (leading dimension ld,
// top-left (row0, col0)), read 16 bytes per chunk into registers; rows
// outside [lo, hi) and columns at or past `cols` read as zeros. `put`
// widens it to f32 into shared memory as dst[r][c] or, TRANS, dst[c][r].
template <typename T, int ROWS, int COLS>
struct Staged {
  static constexpr int kElems = 16 / sizeof(T);
  static constexpr int kChunks = COLS / kElems;
  static constexpr int kPer = ROWS * kChunks / kThreads;
  static_assert(ROWS * kChunks % kThreads == 0, "tile is not whole chunks");
  uint4 raw[kPer];

  __device__ __forceinline__ void get(const T* src, long long ld, int row0,
                                      int lo, int hi, int col0, int cols) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int gr = row0 + c / kChunks, gc = col0 + (c % kChunks) * kElems;
      raw[i] = gr >= lo && gr < hi && gc < cols
                   ? *reinterpret_cast<const uint4*>(src + gr * ld + gc)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  template <bool TRANS>
  __device__ __forceinline__ void put(float* dst) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kChunks, cc = (c % kChunks) * kElems;
      const T* v = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        if constexpr (TRANS)
          dst[(cc + e) * kFmaLd + r] = to_float(v[e]);
        else
          dst[r * kFmaLd + cc + e] = to_float(v[e]);
      }
    }
  }
};

template <int L, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
    grouped_fma_kernel(const Args a) {
  // As[k][m] and Bs[k][n], two stages
  __shared__ __align__(16) float As[2][kFmaBK * kFmaLd];
  __shared__ __align__(16) float Bs[2][kFmaBK * kFmaLd];
  const TA* lhs = static_cast<const TA*>(a.lhs);
  const TB* rhs = static_cast<const TB*>(a.rhs);
  const int n0 = blockIdx.x * kBN;

  int group, m0, lo, hi;
  if constexpr (L == kTN) {
    group = blockIdx.z;
    m0 = blockIdx.y * kBM;
    group_rows(a.sizes, group, a.M, &lo, &hi);
    if (hi <= lo) {
      store_zeros(a.out, a.out_bf16, static_cast<long long>(group) * a.K, m0,
                  min(m0 + kBM, a.K), n0, a.N);
      return;
    }
  } else {
    if (!find_visit(a.sizes, a.E, a.M, blockIdx.y, &group, &m0, &lo, &hi))
      return;
    if (group < 0) {
      store_zeros(a.out, a.out_bf16, 0, lo, hi, n0, a.N);
      return;
    }
    rhs += static_cast<long long>(group) * a.K * a.N;
  }
  const int depth = L == kTN ? hi - lo : a.K;
  const int steps = (depth + kFmaBK - 1) / kFmaBK;

  // A (m x k): lhs rows are m (gmm, gmm_t; stored transposed) or the
  // contraction (tgmm; stored as read). B (k x n): rhs[g] is [K, N] (gmm)
  // or [N, K] (gmm_t; stored transposed); tgmm's rhs is [M, N].
  using StageA = Staged<TA, L == kTN ? kFmaBK : kBM, L == kTN ? kBM : kFmaBK>;
  using StageB = Staged<TB, L == kNT ? kBN : kFmaBK, L == kNT ? kFmaBK : kBN>;
  StageA sa;
  StageB sb;
  auto fetch = [&](int step) {
    const int k0 = step * kFmaBK;
    if constexpr (L == kTN) {
      sa.get(lhs, a.K, lo + k0, lo, hi, m0, a.K);
      sb.get(rhs, a.N, lo + k0, lo, hi, n0, a.N);
    } else {
      sa.get(lhs, a.K, m0, lo, hi, k0, a.K);
      if constexpr (L == kNN)
        sb.get(rhs, a.N, k0, 0, a.K, n0, a.N);
      else
        sb.get(rhs, a.K, n0, 0, a.N, k0, a.K);
    }
  };
  auto stash = [&](int stage) {
    sa.template put<L != kTN>(As[stage]);
    sb.template put<L == kNT>(Bs[stage]);
  };

  // thread (ty, tx) owns rows {ty*4 + i, 64 + ty*4 + i} and columns
  // {tx*4 + j, 64 + tx*4 + j}: 16-byte shared reads, no bank conflict
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    if (step + 1 < steps) fetch(step + 1);
    const float* as = As[cur];
    const float* bs = Bs[cur];
#pragma unroll 4
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float x[8], y[8];
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kFmaLd +
                                                         ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kFmaLd +
                                                         64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kFmaLd +
                                                         tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kFmaLd +
                                                         64 + tx * 4);
      x[0] = a0.x; x[1] = a0.y; x[2] = a0.z; x[3] = a0.w;
      x[4] = a1.x; x[5] = a1.y; x[6] = a1.z; x[7] = a1.w;
      y[0] = b0.x; y[1] = b0.y; y[2] = b0.z; y[3] = b0.w;
      y[4] = b1.x; y[5] = b1.y; y[6] = b1.z; y[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    if (step + 1 < steps) stash(cur ^ 1);
    __syncthreads();
  }

  const long long row_base = L == kTN ? static_cast<long long>(group) * a.K
                                      : 0;
  const int row_lo = L == kTN ? 0 : lo;
  const int row_hi = L == kTN ? a.K : hi;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row < row_lo || row >= row_hi) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (col >= a.N) continue;
      const long long at = (row_base + row) * a.N + col;
      const float* v = acc[i] + 4 * h;
      if (a.out_bf16) {
        __nv_bfloat162 lo2 = __floats2bfloat162_rn(v[0], v[1]);
        __nv_bfloat162 hi2 = __floats2bfloat162_rn(v[2], v[3]);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo2);
        packed.y = *reinterpret_cast<uint32_t*>(&hi2);
        *reinterpret_cast<uint2*>(static_cast<bf16*>(a.out) + at) = packed;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + at) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------

template <int L, typename TA, typename TB>
cudaError_t launch_fma(const Args& a, dim3 grid, cudaStream_t s) {
  grouped_fma_kernel<L, TA, TB><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch(int lhs_bf16, int rhs_bf16, const Args& a,
                   cudaStream_t s) {
  const long long tiles_n = (a.N + kBN - 1) / kBN;
  const long long rows =
      L == kTN ? (a.K + kBM - 1) / kBM : (a.M + kBM - 1) / kBM + a.E;
  if (tiles_n > 0x7fffffffLL || rows > 65535 || a.E > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles_n), static_cast<unsigned>(rows),
                  L == kTN ? a.E : 1);
  if (lhs_bf16 && rhs_bf16) {
    auto kernel = grouped_mma_kernel<L>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(MmaTiles<L>::kSmem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, MmaTiles<L>::kSmem, s>>>(a);
    return cudaGetLastError();
  }
  if (lhs_bf16) return launch_fma<L, bf16, float>(a, grid, s);
  if (rhs_bf16) return launch_fma<L, float, bf16>(a, grid, s);
  return launch_fma<L, float, float>(a, grid, s);
}

int entry(int layout, int lhs_dtype, int rhs_dtype, int out_dtype,
          const void* lhs, const void* rhs, const int* sizes, void* out,
          int M, int K, int N, int E, void* stream) {
  const bool ok = lhs_dtype >= 0 && lhs_dtype <= 1 && rhs_dtype >= 0 &&
                  rhs_dtype <= 1 && out_dtype >= 0 && out_dtype <= 1 &&
                  M >= 0 && K >= 8 && N >= 8 && K % 8 == 0 && N % 8 == 0 &&
                  E >= 1;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{lhs, rhs, sizes, out, M, K, N, E, out_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (layout) {
    case kNN: err = launch<kNN>(lhs_dtype, rhs_dtype, a, s); break;
    case kNT: err = launch<kNT>(lhs_dtype, rhs_dtype, a, s); break;
    default: err = launch<kTN>(lhs_dtype, rhs_dtype, a, s); break;
  }
  return static_cast<int>(err);
}

}  // namespace

// dtypes: 0 f32, 1 bf16. K and N multiples of 8 (16-byte rows), pointers
// 16-byte aligned, group_sizes an [E] int32 array on the device. Each
// returns a cudaError_t (0 = launched).

// out [M, N] = per group lhs [M, K] . rhs[g] [K, N]
extern "C" int flashy_gmm(int lhs_dtype, int rhs_dtype, int out_dtype,
                          const void* lhs, const void* rhs,
                          const int* group_sizes, void* out, int M, int K,
                          int N, int E, void* stream) {
  return entry(kNN, lhs_dtype, rhs_dtype, out_dtype, lhs, rhs, group_sizes,
               out, M, K, N, E, stream);
}

// out [M, N] = per group lhs [M, K] . rhs[g]^T, rhs [E, N, K]
extern "C" int flashy_gmm_t(int lhs_dtype, int rhs_dtype, int out_dtype,
                            const void* lhs, const void* rhs,
                            const int* group_sizes, void* out, int M, int K,
                            int N, int E, void* stream) {
  return entry(kNT, lhs_dtype, rhs_dtype, out_dtype, lhs, rhs, group_sizes,
               out, M, K, N, E, stream);
}

// out [E, K, N]: out[g] = lhs[rows of g]^T . rhs[rows of g], lhs [M, K],
// rhs [M, N]
extern "C" int flashy_tgmm(int lhs_dtype, int rhs_dtype, int out_dtype,
                           const void* lhs, const void* rhs,
                           const int* group_sizes, void* out, int M, int K,
                           int N, int E, void* stream) {
  return entry(kTN, lhs_dtype, rhs_dtype, out_dtype, lhs, rhs, group_sizes,
               out, M, K, N, E, stream);
}
