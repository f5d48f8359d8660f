// Flash attention, forward and backward, on Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of flashy_tpu/ops/attention.py:
//   * flash_fwd_kernel            <- `_flash_kernel` (launched by
//     `_flash_forward`): blockwise online softmax, out + per-row
//     logsumexp;
//   * flash_bwd_dq_kernel         <- `_flash_dq_kernel` (split backward,
//     `_flash_backward`): dQ with the k-blocks innermost;
//   * flash_bwd_kv_kernel<false>  <- `_flash_dkv_kernel` (split
//     backward): dK, dV with the q-blocks innermost;
//   * flash_bwd_kv_kernel<true>   <- `_flash_bwd_fused_kernel`
//     (`_flash_backward_fused`): dK, dV as the split kernel, plus one f32
//     dQ partial per (k-block, q-block) pair, written to a
//     [nk, B, Tq, H, D] buffer that the caller folds in k order.
//
// Each computes what its Pallas body computes, not a block-by-block copy:
//   * scores q.k in f32, times scale (1/sqrt(D) of the flash path, f64
//     rounded to f32), then masked to NEG_INF = -1e30: causal bottom-right
//     (key j visible to query i iff i + (Tk - Tq) >= j) and, where T is
//     not a multiple of the tile, the ragged edge;
//   * the guarded exp of `_guarded_probs`: a row whose running max (in
//     the forward) or logsumexp (in the backward) is still <= NEG_INF/2
//     has zero probabilities, so a query with no visible key gets zero
//     output and zero gradients; lse = m + log(max(l, 1e-30));
//   * rounding points: P is rounded to V's dtype before P.V and to dO's
//     dtype before P^T.dO; dS = P * (dP - D) * scale is rounded to K's
//     dtype for dS.K and to Q's dtype for dS^T.Q (all four share one
//     dtype here). Products and sums are f32.
//   * the online softmax steps once per 64-key tile, so bf16 results
//     depend on the tile; the plain version in ops/attention.py steps at
//     the same tile.
//
// Fused and split backward are bit-identical: every (q-block, k-block)
// pair computes S, P, dP and dS with the same device code, each block
// product starts from zero and runs the same instruction sequence
// (explicit fmaf in ascending order, or the same mma.sync steps), and
// the accumulators add whole block products with non-contracted adds
// (__fadd_rn). The split dQ kernel adds the block
// products dS.K in k order; the fused kernel writes the same block
// products (exact zeros for causally skipped pairs), and the caller's
// left fold in k order performs the same additions. No atomics.
//
// What bounds it on this card: operations. At the training shapes
// (B*H = 256, T = 1024, D = 64, causal) a forward does ~34 GFLOP against
// ~135 MB of inputs and outputs, a backward ~86 GFLOP against ~236 MB,
// far above the ~295 flops per byte where the H100 leaves the memory
// bound, so the block products belong on the tensor cores. Each 64x64
// block product is split over the eight warps in the m16n8k16 fragment
// layout of `mma.sync` (a warp owns 16 rows and 32 columns). In bf16
// every operand tile is bf16-exact (Q, K, V and dO as loaded, P and dS
// after their rounding), so the bf16 kernels run the products as
// `mma.sync` with f32 accumulation, exactly the bf16-operand,
// f32-accumulate products of the Pallas bodies. The f32 kernels keep
// f32 FMAs in the same layout, contracting in ascending order. The T x
// T score matrix never reaches device memory: S, P and dS live in shared
// memory one 64x64 f32 tile at a time (padded rows), as the TPU kernels
// keep them in VMEM. The TPU grid's sequential innermost axis, carried
// in VMEM scratch, becomes a loop inside one thread block with the
// running statistics in shared memory and the accumulators in
// registers. wgmma, TMA, bf16 tiles in shared memory and a pipelined
// K/V ring are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlock = 64;             // q and k tile (FLASH_BLOCK)
constexpr int kDim = 64;               // head_dim compiled (FLASH_HEAD_DIMS)
constexpr int kThreads = 256;          // 8 warps, 16 x 32 outputs each
constexpr int kWarps = kThreads / 32;
// padded row of a [64][64] f32 tile: a multiple of 4 floats for 16-byte
// stores, and 8 (mod 32) so that a warp's fragment reads along a row,
// 8 bytes a lane, hit 16 distinct bank pairs per half-warp
constexpr int kLd = kBlock + 8;
constexpr int kTile = kBlock * kLd;    // floats per tile
static_assert(kBlock == kDim && kThreads == 256,
              "the warp tiling assumes 64x64 tiles over 8 warps");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded to T's precision, returned as f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

struct Geometry {
  int B, H, Tq, Tk, offset;  // offset = Tk - Tq
  int causal;
  float scale;
};

// first element of row (b, t, h) of a contiguous [B, T, H, kDim] tensor
__device__ __forceinline__ size_t row_at(int b, int t, int h, int T, int H) {
  return ((static_cast<size_t>(b) * T + t) * H + h) * kDim;
}

// rows row0..row0+63 of head (b, h) into a padded f32 tile; rows past T
// are zero. 16-byte loads (the wrapper aligns the tensors), all of a
// thread's issued before any is stored, so their latencies overlap.
template <typename T>
__device__ void load_rows(float* dst, const T* __restrict__ src, int b,
                          int h, int row0, int rows, int H) {
  constexpr int kVec = 16 / sizeof(T);                // elements per load
  constexpr int kRowChunks = kDim / kVec;
  constexpr int kPer = kBlock * kRowChunks / kThreads;  // loads a thread
  uint4 raw[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    const int t = row0 + chunk / kRowChunks;
    raw[i] = t < rows
                 ? *reinterpret_cast<const uint4*>(
                       src + row_at(b, t, h, rows, H) +
                       (chunk % kRowChunks) * kVec)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    float* out =
        dst + (chunk / kRowChunks) * kLd + (chunk % kRowChunks) * kVec;
    const T* values = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
    for (int v = 0; v < kVec; v += 4)
      *reinterpret_cast<float4*>(out + v) =
          make_float4(to_float(values[v]), to_float(values[v + 1]),
                      to_float(values[v + 2]), to_float(values[v + 3]));
  }
}

// per-row f32 statistic [B*H, T] for rows row0..row0+63; `fill` past T
__device__ void load_stat(float* dst, const float* __restrict__ src, int bh,
                          int row0, int rows, float fill) {
  for (int r = threadIdx.x; r < kBlock; r += kThreads) {
    const int t = row0 + r;
    dst[r] = t < rows ? src[static_cast<size_t>(bh) * rows + t] : fill;
  }
}

// A 64x64 block product in the m16n8k16 fragment layout: warp w owns
// rows 16*(w % 4) .. +15 and columns 32*(w / 4) .. +31, as four 16x8
// tiles; element e of tile j of a thread sits at (tile_row(e),
// tile_col(j, e)).
__device__ __forceinline__ int tile_row(int e) {
  const int lane = threadIdx.x & 31;
  return 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int tile_col(int j, int e) {
  const int lane = threadIdx.x & 31;
  return 32 * (threadIdx.x >> 7) + 8 * j + 2 * (lane & 3) + (e & 1);
}

// two bf16-exact f32 values as one bf16x2 register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// x[0] and x[stride]: one 8-byte load when they are adjacent
template <int kStride>
__device__ __forceinline__ float2 pair_at(const float* x) {
  if constexpr (kStride == 1) return *reinterpret_cast<const float2*>(x);
  return make_float2(x[0], x[kStride]);
}

// f = A B from zero, contracting over 64: A(m, k) = a[m*AM + k*AK],
// B(k, n) = b[k*BK + n*BN], both f32 tiles in shared memory. T = float:
// fmaf in ascending k. T = bf16: the operands are bf16-exact, and the
// product runs as four mma.sync k-steps. Either way the result does not
// depend on which kernel runs it.
template <typename T, int AM, int AK, int BK, int BN>
__device__ __forceinline__ void product(const float* a, const float* b,
                                        float f[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + g, r1 = r0 + 8;
  const int n0 = 32 * (threadIdx.x >> 7);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[j][e] = 0.f;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll 4
    for (int k = 0; k < kBlock; ++k) {
      const float a0 = a[r0 * AM + k * AK], a1 = a[r1 * AM + k * AK];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        const float b0 = b[k * BK + c * BN], b1 = b[k * BK + (c + 1) * BN];
        f[j][0] = fmaf(a0, b0, f[j][0]);
        f[j][1] = fmaf(a0, b1, f[j][1]);
        f[j][2] = fmaf(a1, b0, f[j][2]);
        f[j][3] = fmaf(a1, b1, f[j][3]);
      }
    }
  } else {
#pragma unroll
    for (int k0 = 0; k0 < kBlock; k0 += 16) {
      const int k = k0 + 2 * t;
      uint32_t af[4];
      float2 x = pair_at<AK>(a + r0 * AM + k * AK);
      af[0] = pack_bf16(x.x, x.y);
      x = pair_at<AK>(a + r1 * AM + k * AK);
      af[1] = pack_bf16(x.x, x.y);
      x = pair_at<AK>(a + r0 * AM + (k + 8) * AK);
      af[2] = pack_bf16(x.x, x.y);
      x = pair_at<AK>(a + r1 * AM + (k + 8) * AK);
      af[3] = pack_bf16(x.x, x.y);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 8 * j + g;
        const float2 y0 = pair_at<BK>(b + k * BK + n * BN);
        const float2 y1 = pair_at<BK>(b + (k + 8) * BK + n * BN);
        mma_bf16(f[j], af, pack_bf16(y0.x, y0.y), pack_bf16(y1.x, y1.y));
      }
    }
  }
}

// A B^T, A B and A^T B of padded [64][kLd] tiles
template <typename T>
__device__ __forceinline__ void product_abt(const float* a, const float* b,
                                            float f[4][4]) {
  product<T, kLd, 1, 1, kLd>(a, b, f);
}
template <typename T>
__device__ __forceinline__ void product_ab(const float* a, const float* b,
                                           float f[4][4]) {
  product<T, kLd, 1, kLd, 1>(a, b, f);
}
template <typename T>
__device__ __forceinline__ void product_atb(const float* a, const float* b,
                                            float f[4][4]) {
  product<T, 1, kLd, kLd, 1>(a, b, f);
}

// whether key k_pos exists and query q_pos may see it
__device__ __forceinline__ bool visible(int q_pos, int k_pos,
                                        const Geometry& g) {
  return k_pos < g.Tk && (!g.causal || q_pos + g.offset >= k_pos);
}

// whether k-block ki holds a key visible to some row of q-block qi
// (`_causal_visible`)
__device__ __forceinline__ bool block_visible(int qi, int ki,
                                              const Geometry& g) {
  return !g.causal || ki * kBlock <= qi * kBlock + kBlock - 1 + g.offset;
}

// the last k-block that q-block qi visits; -1 when it sees none
__device__ __forceinline__ int last_kblock(int qi, const Geometry& g) {
  const int last = (g.Tk - 1) / kBlock;
  if (!g.causal) return last;
  const int reach = qi * kBlock + kBlock - 1 + g.offset;
  return reach < 0 ? -1 : min(last, reach / kBlock);
}

// The backward's per-pair block: S recomputed, P = guarded exp(S - lse)
// rounded to T into p_s, dP = dO V^T, dS = P (dP - D) scale rounded to T
// into ds_s. Shared by all three backward kernels.
template <typename T>
__device__ void probs_and_ds(const float* q_s, const float* k_s,
                             const float* v_s, const float* do_s,
                             const float* lse_s, const float* delta_s,
                             float* p_s, float* ds_s, int q0, int k0,
                             const Geometry& g) {
  float s[4][4], dp[4][4];
  product_abt<T>(q_s, k_s, s);
  product_abt<T>(do_s, v_s, dp);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = tile_row(e), c = tile_col(j, e);
      const float lse = lse_s[r];
      const float score = visible(q0 + r, k0 + c, g)
                              ? __fmul_rn(s[j][e], g.scale) : kNegInf;
      const float p = lse > kNegInf * 0.5f ? expf(__fsub_rn(score, lse))
                                           : 0.f;
      const float ds =
          __fmul_rn(__fmul_rn(p, __fsub_rn(dp[j][e], delta_s[r])), g.scale);
      p_s[r * kLd + c] = round_to<T>(p);
      ds_s[r * kLd + c] = round_to<T>(ds);
    }
}

// Forward: one block per (b*h, q-block); loops over the k-blocks up to
// the last causally visible one. Layouts: q, out [B, Tq, H, D]; k, v
// [B, Tk, H, D]; lse [B, H, Tq] f32.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Geometry g) {
  const int bh = blockIdx.x, qi = blockIdx.y;
  const int b = bh / g.H, h = bh - b * g.H;
  const int q0 = qi * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile;
  float* v_s = k_s + kTile;
  float* p_s = v_s + kTile;        // scores, then probabilities
  float* m_s = p_s + kTile;        // [64] running max
  float* l_s = m_s + kBlock;       // [64] running normalizer
  float* a_s = l_s + kBlock;       // [64] this tile's rescale factor

  load_rows(q_s, q, b, h, q0, g.Tq, g.H);
  for (int r = tid; r < kBlock; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int last = last_kblock(qi, g);
  for (int ki = 0; ki <= last; ++ki) {
    const int k0 = ki * kBlock;
    __syncthreads();  // the previous tile's P.V is done with k_s, v_s, p_s
    load_rows(k_s, k, b, h, k0, g.Tk, g.H);
    load_rows(v_s, v, b, h, k0, g.Tk, g.H);
    __syncthreads();

    float s[4][4];
    product_abt<T>(q_s, k_s, s);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = tile_row(e), c = tile_col(j, e);
        p_s[r * kLd + c] = visible(q0 + r, k0 + c, g)
                               ? __fmul_rn(s[j][e], g.scale) : kNegInf;
      }
    __syncthreads();

    // online softmax, one warp per row, two keys per lane
    for (int r = warp; r < kBlock; r += kWarps) {
      float* row = p_s + r * kLd;
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const bool live = m_new > kNegInf * 0.5f;
      const float p0 = live ? expf(__fsub_rn(x0, m_new)) : 0.f;
      const float p1 = live ? expf(__fsub_rn(x1, m_new)) : 0.f;
      float sum = __fadd_rn(p0, p1);
      for (int o = 16; o > 0; o >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      const float alpha = expf(__fsub_rn(m_prev, m_new));
      __syncwarp();
      if (lane == 0) {
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum);
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
      row[lane] = round_to<T>(p0);
      row[lane + 32] = round_to<T>(p1);
    }
    __syncthreads();

    float pv[4][4];
    product_ab<T>(p_s, v_s, pv);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = __fadd_rn(__fmul_rn(acc[j][e], a_s[tile_row(e)]),
                              pv[j][e]);
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = tile_row(e), t = q0 + r;
      if (t < g.Tq)
        out[row_at(b, t, h, g.Tq, g.H) + tile_col(j, e)] =
            from_float<T>(__fdiv_rn(acc[j][e], fmaxf(l_s[r], 1e-30f)));
    }
  for (int r = tid; r < kBlock; r += kThreads) {
    const int t = q0 + r;
    if (t < g.Tq)
      lse[static_cast<size_t>(bh) * g.Tq + t] =
          __fadd_rn(m_s[r], logf(fmaxf(l_s[r], 1e-30f)));
  }
}

// Split backward dQ: one block per (b*h, q-block), k-blocks innermost;
// dQ += dS.K one whole block product at a time, in k order. lse and
// delta are [B, H, Tq] f32; dq is [B, Tq, H, D] in q's dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Geometry g) {
  const int bh = blockIdx.x, qi = blockIdx.y;
  const int b = bh / g.H, h = bh - b * g.H;
  const int q0 = qi * kBlock;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile;
  float* k_s = do_s + kTile;
  float* v_s = k_s + kTile;
  float* p_s = v_s + kTile;
  float* ds_s = p_s + kTile;
  float* lse_s = ds_s + kTile;
  float* delta_s = lse_s + kBlock;

  load_rows(q_s, q, b, h, q0, g.Tq, g.H);
  load_rows(do_s, dout, b, h, q0, g.Tq, g.H);
  load_stat(lse_s, lse, bh, q0, g.Tq, kNegInf);
  load_stat(delta_s, delta, bh, q0, g.Tq, 0.f);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int last = last_kblock(qi, g);
  for (int ki = 0; ki <= last; ++ki) {
    const int k0 = ki * kBlock;
    __syncthreads();
    load_rows(k_s, k, b, h, k0, g.Tk, g.H);
    load_rows(v_s, v, b, h, k0, g.Tk, g.H);
    __syncthreads();
    probs_and_ds<T>(q_s, k_s, v_s, do_s, lse_s, delta_s, p_s, ds_s, q0, k0,
                    g);
    __syncthreads();
    float blk[4][4];
    product_ab<T>(ds_s, k_s, blk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], blk[j][e]);
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = q0 + tile_row(e);
      if (t < g.Tq)
        dq[row_at(b, t, h, g.Tq, g.H) + tile_col(j, e)] =
            from_float<T>(acc[j][e]);
    }
}

// Backward dK/dV (split, FUSED = false) or the one-pass backward (FUSED =
// true): one block per (b*h, k-block), q-blocks innermost. dV += P^T.dO
// and dK += dS^T.Q one whole block product at a time, in q order. The
// fused kernel also writes each pair's dS.K to dqp [nk, B, Tq, H, D] f32,
// and exact zeros for the pairs that causality skips.
template <typename T, bool FUSED>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, float* __restrict__ dqp,
                    Geometry g) {
  const int bh = blockIdx.x, ki = blockIdx.y;
  const int b = bh / g.H, h = bh - b * g.H;
  const int k0 = ki * kBlock;
  const int nq = (g.Tq + kBlock - 1) / kBlock;

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile;
  float* q_s = v_s + kTile;
  float* do_s = q_s + kTile;
  float* p_s = do_s + kTile;
  float* ds_s = p_s + kTile;
  float* lse_s = ds_s + kTile;
  float* delta_s = lse_s + kBlock;

  load_rows(k_s, k, b, h, k0, g.Tk, g.H);
  load_rows(v_s, v, b, h, k0, g.Tk, g.H);
  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qi = 0; qi < nq; ++qi) {
    const int q0 = qi * kBlock;
    if (!block_visible(qi, ki, g)) {
      if (FUSED) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = q0 + tile_row(e);
            if (t < g.Tq)
              dqp[row_at(ki * g.B + b, t, h, g.Tq, g.H) + tile_col(j, e)] =
                  0.f;
          }
      }
      continue;
    }
    __syncthreads();
    load_rows(q_s, q, b, h, q0, g.Tq, g.H);
    load_rows(do_s, dout, b, h, q0, g.Tq, g.H);
    load_stat(lse_s, lse, bh, q0, g.Tq, kNegInf);
    load_stat(delta_s, delta, bh, q0, g.Tq, 0.f);
    __syncthreads();
    probs_and_ds<T>(q_s, k_s, v_s, do_s, lse_s, delta_s, p_s, ds_s, q0, k0,
                    g);
    __syncthreads();
    float blk[4][4];
    product_atb<T>(p_s, do_s, blk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dv_acc[j][e] = __fadd_rn(dv_acc[j][e], blk[j][e]);
    product_atb<T>(ds_s, q_s, blk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dk_acc[j][e] = __fadd_rn(dk_acc[j][e], blk[j][e]);
    if (FUSED) {
      product_ab<T>(ds_s, k_s, blk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = q0 + tile_row(e);
          if (t < g.Tq)
            dqp[row_at(ki * g.B + b, t, h, g.Tq, g.H) + tile_col(j, e)] =
                blk[j][e];
        }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = k0 + tile_row(e);
      if (t < g.Tk) {
        const size_t at = row_at(b, t, h, g.Tk, g.H) + tile_col(j, e);
        dk[at] = from_float<T>(dk_acc[j][e]);
        dv[at] = from_float<T>(dv_acc[j][e]);
      }
    }
}

constexpr size_t kFwdSmem = (4 * kTile + 3 * kBlock) * sizeof(float);
constexpr size_t kBwdSmem = (6 * kTile + 2 * kBlock) * sizeof(float);

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t forward(const void* q, const void* k, const void* v, void* out,
                    float* lse, const Geometry& g, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, kFwdSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(g.B * g.H, (g.Tq + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, kFwdSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(int kind, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, void* dk, void* dv, float* dqp,
                     const Geometry& g, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  cudaError_t err;
  if (kind == 0) {
    auto kernel = flash_bwd_dq_kernel<T>;
    if ((err = allow_smem(kernel, kBwdSmem)) != cudaSuccess) return err;
    dim3 grid(g.B * g.H, (g.Tq + kBlock - 1) / kBlock);
    kernel<<<grid, kThreads, kBwdSmem, stream>>>(q_, k_, v_, do_, lse, delta,
                                                  static_cast<T*>(dq), g);
  } else {
    auto kernel = kind == 1 ? flash_bwd_kv_kernel<T, false>
                            : flash_bwd_kv_kernel<T, true>;
    if ((err = allow_smem(kernel, kBwdSmem)) != cudaSuccess) return err;
    dim3 grid(g.B * g.H, (g.Tk + kBlock - 1) / kBlock);
    kernel<<<grid, kThreads, kBwdSmem, stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), dqp, g);
  }
  return cudaGetLastError();
}

bool valid(int dtype, int B, int H, int Tq, int Tk, int D) {
  return (dtype == 0 || dtype == 1) && B >= 1 && H >= 1 && Tq >= 1 &&
         Tk >= 1 && D == kDim &&
         static_cast<long long>(B) * H <= 0x7fffffffLL &&
         (Tq + kBlock - 1) / kBlock <= 65535 &&
         (Tk + kBlock - 1) / kBlock <= 65535;
}

}  // namespace

// dtype: 0 f32, 1 bf16. Returns a cudaError_t (0 = launched).
extern "C" int flashy_flash_forward(int dtype, const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    int B, int H, int Tq, int Tk, int D,
                                    int causal, float scale, void* stream) {
  if (!valid(dtype, B, H, Tq, Tk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{B, H, Tq, Tk, Tk - Tq, causal ? 1 : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? forward<float>(q, k, v, out, lse, g, s)
                 : forward<__nv_bfloat16>(q, k, v, out, lse, g, s));
}

// kind: 0 split dQ (writes dq), 1 split dK/dV (dk, dv), 2 fused (dk, dv
// and the dQ partials dqp). Returns a cudaError_t (0 = launched).
extern "C" int flashy_flash_backward(int kind, int dtype, const void* q,
                                     const void* k, const void* v,
                                     const void* dout, const float* lse,
                                     const float* delta, void* dq, void* dk,
                                     void* dv, float* dqp, int B, int H,
                                     int Tq, int Tk, int D, int causal,
                                     float scale, void* stream) {
  if (kind < 0 || kind > 2 || !valid(dtype, B, H, Tq, Tk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{B, H, Tq, Tk, Tk - Tq, causal ? 1 : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? backward<float>(kind, q, k, v, dout, lse, delta, dq, dk,
                                   dv, dqp, g, s)
                 : backward<__nv_bfloat16>(kind, q, k, v, dout, lse, delta,
                                           dq, dk, dv, dqp, g, s));
}
