// Tile code shared by the flash-attention kernels (flash_attention.cu) and
// the ring-attention kernel (ring_attention.cu): the 64x64 f32 tiles in
// shared memory, the m16n8k16 block products (mma.sync for bf16, ordered
// FMAs for f32), and one 64-key step of the forward's online softmax.
// Both forwards run the same step, so they round where each other rounds:
// a one-rank ring is bit-equal to the flash forward over the same keys.
#pragma once
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

// The forward's shared memory: Q, K, V and S/P tiles, then the running
// max, the running normalizer and the current tile's rescale factor, one
// float per row each.
struct ForwardSmem {
  float *q, *k, *v, *p, *m, *l, *a;
};
constexpr size_t kFwdSmem = (4 * kTile + 3 * kBlock) * sizeof(float);

__device__ __forceinline__ ForwardSmem forward_smem(float* smem) {
  ForwardSmem s;
  s.q = smem;
  s.k = s.q + kTile;
  s.v = s.k + kTile;
  s.p = s.v + kTile;   // scores, then probabilities
  s.m = s.p + kTile;
  s.l = s.m + kBlock;
  s.a = s.l + kBlock;
  return s;
}

// Q rows q0.. of head (b, h) into shared memory (rows past Tq zero), the
// running statistics and the accumulator to their empty state.
template <typename T>
__device__ __forceinline__ void forward_begin(const ForwardSmem& s,
                                              const T* __restrict__ q, int b,
                                              int h, int q0, int Tq, int H,
                                              float acc[4][4]) {
  load_rows(s.q, q, b, h, q0, Tq, H);
  for (int r = threadIdx.x; r < kBlock; r += kThreads) {
    s.m[r] = kNegInf;
    s.l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// One 64-key step of the online softmax: K and V rows k0.. of head (b, h)
// of a [B, Tk, H, kDim] pair (rows past Tk zero), S = Q K^T times scale,
// NEG_INF where !shown(r, c) (tile row r, tile column c), the running max
// and the guarded exp, P rounded to T, acc = acc * alpha + P V.
template <typename T, typename Shown>
__device__ __forceinline__ void forward_tile(const ForwardSmem& s,
                                             const T* __restrict__ k,
                                             const T* __restrict__ v, int b,
                                             int h, int k0, int Tk, int H,
                                             float scale, Shown shown,
                                             float acc[4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous tile's P.V is done with k, v and p
  load_rows(s.k, k, b, h, k0, Tk, H);
  load_rows(s.v, v, b, h, k0, Tk, H);
  __syncthreads();

  float sc[4][4];
  product_abt<T>(s.q, s.k, sc);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = tile_row(e), c = tile_col(j, e);
      s.p[r * kLd + c] = shown(r, c) ? __fmul_rn(sc[j][e], scale) : kNegInf;
    }
  __syncthreads();

  // online softmax, one warp per row, two keys per lane
  for (int r = warp; r < kBlock; r += kWarps) {
    float* row = s.p + r * kLd;
    const float x0 = row[lane], x1 = row[lane + 32];
    float mx = fmaxf(x0, x1);
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_prev = s.m[r];
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
      s.l[r] = __fadd_rn(__fmul_rn(s.l[r], alpha), sum);
      s.m[r] = m_new;
      s.a[r] = alpha;
    }
    row[lane] = round_to<T>(p0);
    row[lane + 32] = round_to<T>(p1);
  }
  __syncthreads();

  float pv[4][4];
  product_ab<T>(s.p, s.v, pv);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = __fadd_rn(__fmul_rn(acc[j][e], s.a[tile_row(e)]),
                            pv[j][e]);
}

// out = acc / max(l, 1e-30) in T for rows q0.. of head (b, h) of a
// [B, Tq, H, kDim] tensor, and lse = m + log(max(l, 1e-30)) into the f32
// [B*H, Tq] rows; rows past Tq are not written.
template <typename T>
__device__ __forceinline__ void forward_end(const ForwardSmem& s,
                                            T* __restrict__ out,
                                            float* __restrict__ lse, int b,
                                            int h, int q0, int Tq, int H,
                                            float acc[4][4]) {
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = tile_row(e), t = q0 + r;
      if (t < Tq)
        out[row_at(b, t, h, Tq, H) + tile_col(j, e)] =
            from_float<T>(__fdiv_rn(acc[j][e], fmaxf(s.l[r], 1e-30f)));
    }
  const int bh = b * H + h;
  for (int r = threadIdx.x; r < kBlock; r += kThreads) {
    const int t = q0 + r;
    if (t < Tq)
      lse[static_cast<size_t>(bh) * Tq + t] =
          __fadd_rn(s.m[r], logf(fmaxf(s.l[r], 1e-30f)));
  }
}

}  // namespace
