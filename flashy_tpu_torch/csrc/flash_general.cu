// Flash attention at every head_dim: the general route of the flash
// forward, the split and fused backward and the ring forward on Hopper
// (sm_90a), for f32 inputs at every head_dim and bf16 at those other than
// 64 and 128.
//
// Replaces the same Pallas TPU kernels as flash_attention.cu and
// ring_attention.cu, which take bf16 at 64 and 128:
//   * flash_general_fwd_kernel       <- `_flash_kernel` (`_flash_forward`,
//     flashy_tpu/ops/attention.py) and, over a table of key segments,
//     `_fused_kernel` (`_fused_forward`, flashy_tpu/parallel/ring_fused.py);
//   * flash_general_dq_kernel        <- `_flash_dq_kernel` (split dQ);
//   * flash_general_kv_kernel<false> <- `_flash_dkv_kernel` (split dK/dV);
//   * flash_general_kv_kernel<true>  <- `_flash_bwd_fused_kernel`: dK, dV
//     and one f32 dQ partial per (k-block, q-block) pair into [nk, B, Tq,
//     H, D], which the caller folds in k order.
// Any head_dim D from 1 to 256, f32 or bf16. The wrappers pick this route
// by the shape and dtype (`ops/attention.py` `flash_route`).
//
// What it computes is what flash_attention.cu computes, with the same
// rounding points (its source note): scores q.k in f32 times the flash
// scale of the true D, NEG_INF where hidden (causal bottom-right, ragged
// T), the guarded exp, the online softmax stepping once per 64 keys, P
// rounded to the input dtype before P.V and before P^T dO, dS = P (dP - D)
// scale from the f32 P rounded to the input dtype before dS^T Q and dS K,
// products and sums in f32, lse = m + log(max(l, 1e-30)). Fused and split
// are bit-equal: every (q-block, k-block) pair computes S, P, dP, dS and
// the dQ block product dS K with the same device code (`pair_ds`,
// `product`), block products start from zero, and dQ adds whole block
// products in k order with non-contracted adds (the split kernel in its
// registers, the caller's fold over the fused kernel's partials).
//
// Design: f32 tiles in shared memory at a padded width Dp = 32 NC >= D. A
// tile's rows are D values widened to f32 (bf16 exactly), the lanes
// D..Dp-1 zero-filled on load, so the products over the padded width add
// exact zeros; the contractions over the head dimension run over the true
// D. 256 threads, a thread
// owning a (16-strided) RM x CN block of each product's output, every
// product an ascending FMA chain from shared memory (rows padded to an
// odd length: no bank conflicts along rows or columns). The forward
// holds Q, K and V tiles of 64 rows (~215 KB at Dp 256); the backward
// holds 64-row blocks up to Dp 128 and 32-row blocks above it (four Dp-wide
// tiles must fit), so its dQ partials are per 32 keys there.
//
// What bounds it on this card: operations (4 D flops a visible (query,
// key) pair forward, 10 D backward), at the bf16 tensor cores' rate for
// bf16 inputs. This route runs them as f32 FMAs from shared memory, about
// 1/15 of that rate at best: a simple kernel that is right. The bf16
// Hopper steps at other multiples of 16, and an f32 route on the tensor
// cores (as the grouped kernels' three-term bf16 split), are later work
// (ROADMAP, later kernel work). The fused kernel's partials take nk x the
// bytes of dQ, nk = Tk / 64 (or / 32), so they grow with T^2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;       // keys of a forward step (FLASH_BLOCK)
constexpr int kMaxDim = 256;    // head_dim bound of this route
constexpr int kMaxSegments = 64;
constexpr size_t kMaxSmem = 232448;

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
  return __float2bfloat16_rn(x);
}
// x rounded to T's precision, as f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// element (b, t, h, 0) of a contiguous [B, T, H, D] tensor
__device__ __forceinline__ size_t row_at(int b, int t, int h, int T, int H,
                                         int D) {
  return ((static_cast<size_t>(b) * T + t) * H + h) * D;
}

// rows row0..row0+R-1 of head (b, h) of a [B, T, H, D] tensor into an
// f32 tile [R][ld] of width Dp; rows past T and lanes past D are zero
template <typename IT>
__device__ __forceinline__ void load_tile(float* dst, int ld, int R, int Dp,
                                          const IT* __restrict__ src, int b,
                                          int h, int row0, int T, int H,
                                          int D) {
  for (int i = threadIdx.x; i < R * Dp; i += kThreads) {
    const int r = i / Dp, d = i - r * Dp;
    const int t = row0 + r;
    dst[r * ld + d] = (t < T && d < D)
                          ? to_float(src[row_at(b, t, h, T, H, D) + d])
                          : 0.f;
  }
}

// per-row f32 statistic [B*H, T] for rows row0..row0+R-1; `fill` past T
__device__ __forceinline__ void load_stat(float* dst, int R,
                                          const float* __restrict__ src,
                                          int bh, int row0, int T,
                                          float fill) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int t = row0 + r;
    dst[r] = t < T ? src[static_cast<size_t>(bh) * T + t] : fill;
  }
}

// A thread's outputs of an M x N product: rows tr + 16 i (i < RM), columns
// tc + 16 j (j < CN), tr = thread / 16, tc = thread % 16.
__device__ __forceinline__ int out_row(int i) {
  return (threadIdx.x >> 4) + 16 * i;
}
__device__ __forceinline__ int out_col(int j) {
  return (threadIdx.x & 15) + 16 * j;
}

// f (+)= A B over k = 0..L-1 in ascending order, as fmaf: A(m, k) =
// a[m*am + k*ak], B(k, n) = b[k*bk + n*bn], f32 tiles in shared memory.
// Each output's chain depends on its operands alone, never on which
// kernel or thread computes it.
template <int RM, int CN>
__device__ __forceinline__ void product(const float* a, int am, int ak,
                                        const float* b, int bk, int bn,
                                        int L, float (&f)[RM][CN]) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll 2
  for (int k = 0; k < L; ++k) {
    float av[RM], bv[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = a[(tr + 16 * i) * am + k * ak];
#pragma unroll
    for (int j = 0; j < CN; ++j) bv[j] = b[k * bk + (tc + 16 * j) * bn];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) f[i][j] = fmaf(av[i], bv[j], f[i][j]);
  }
}

template <int RM, int CN>
__device__ __forceinline__ void zero(float (&f)[RM][CN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) f[i][j] = 0.f;
}

// acc += blk, non-contracted
template <int RM, int CN>
__device__ __forceinline__ void add(float (&acc)[RM][CN],
                                    const float (&blk)[RM][CN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = __fadd_rn(acc[i][j], blk[i][j]);
}

// The key segments of a forward: the flash forward has one, the ring
// forward one per visible ring step (owner (rank - step) mod n). Segment
// 0 is causal where `causal0` (bottom-right, offset = Tk - Tq), the
// others fully visible; every segment holds Tk keys.
struct Segments {
  const void* k[kMaxSegments];
  const void* v[kMaxSegments];
  int n, causal0;
};

struct Geometry {
  int B, H, Tq, Tk, D, offset, causal;
  float scale;
};

// ---- forward --------------------------------------------------------------

// One block per (b*h, 64 query rows): the online softmax over every
// segment's keys, 64 at a time. out [B, Tq, H, D] in IT, lse [B*H, Tq].
template <typename IT, int NC>
__global__ void __launch_bounds__(kThreads, 1)
flash_general_fwd_kernel(const IT* __restrict__ q, IT* __restrict__ out,
                         float* __restrict__ lse,
                         const __grid_constant__ Segments segs,
                         const Geometry g) {
  constexpr int Dp = 32 * NC, ld = Dp + 1, ldp = kKeys + 1;
  constexpr int RM = kKeys / 16, CN = Dp / 16;
  const int bh = blockIdx.x, q0 = blockIdx.y * kKeys;
  const int b = bh / g.H, h = bh - b * g.H;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [64][ld]
  float* k_s = q_s + kKeys * ld;     // [64][ld]
  float* v_s = k_s + kKeys * ld;     // [64][ld]
  float* p_s = v_s + kKeys * ld;     // [64][ldp] scores, then P
  float* m_s = p_s + kKeys * ldp;    // [64] running max
  float* l_s = m_s + kKeys;          // [64] normalizer
  float* a_s = l_s + kKeys;          // [64] this step's rescale
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile(q_s, ld, kKeys, Dp, q, b, h, q0, g.Tq, g.H, g.D);
  for (int r = threadIdx.x; r < kKeys; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[RM][CN];
  zero(acc);
  for (int sg = 0; sg < segs.n; ++sg) {
    const bool causal = sg == 0 && segs.causal0;
    const IT* k = static_cast<const IT*>(segs.k[sg]);
    const IT* v = static_cast<const IT*>(segs.v[sg]);
    int last = (g.Tk - 1) / kKeys;
    if (causal) {
      const int reach = q0 + kKeys - 1 + g.offset;
      last = reach < 0 ? -1 : min(last, reach / kKeys);
    }
    for (int ki = 0; ki <= last; ++ki) {
      const int k0 = ki * kKeys;
      __syncthreads();  // the previous step's P.V is done with k, v, p
      load_tile(k_s, ld, kKeys, Dp, k, b, h, k0, g.Tk, g.H, g.D);
      load_tile(v_s, ld, kKeys, Dp, v, b, h, k0, g.Tk, g.H, g.D);
      __syncthreads();
      float s[RM][RM];
      zero(s);
      product(q_s, ld, 1, k_s, 1, ld, g.D, s);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RM; ++j) {
          const int r = out_row(i), c = out_col(j);
          const bool shown =
              k0 + c < g.Tk && (!causal || q0 + r + g.offset >= k0 + c);
          p_s[r * ldp + c] = shown ? __fmul_rn(s[i][j], g.scale) : kNegInf;
        }
      __syncthreads();
      // online softmax, one warp per row, two keys per lane
      for (int r = warp; r < kKeys; r += kWarps) {
        float* row = p_s + r * ldp;
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
        row[lane] = round_to<IT>(p0);
        row[lane + 32] = round_to<IT>(p1);
      }
      __syncthreads();
      float pv[RM][CN];
      zero(pv);
      product(p_s, ldp, 1, v_s, ld, 1, kKeys, pv);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j)
          acc[i][j] =
              __fadd_rn(__fmul_rn(acc[i][j], a_s[out_row(i)]), pv[i][j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = out_row(i), t = q0 + r;
    if (t >= g.Tq) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int c = out_col(j);
      if (c < g.D)
        out[row_at(b, t, h, g.Tq, g.H, g.D) + c] =
            from_float<IT>(__fdiv_rn(acc[i][j], denom));
    }
  }
  for (int r = threadIdx.x; r < kKeys; r += kThreads) {
    const int t = q0 + r;
    if (t < g.Tq)
      lse[static_cast<size_t>(bh) * g.Tq + t] =
          __fadd_rn(m_s[r], logf(fmaxf(l_s[r], 1e-30f)));
  }
}

// ---- backward -------------------------------------------------------------

// whether key k_pos exists and query q_pos may see it
__device__ __forceinline__ bool visible(int q_pos, int k_pos,
                                        const Geometry& g) {
  return k_pos < g.Tk && (!g.causal || q_pos + g.offset >= k_pos);
}

// The pair step of the backward, shared by the three kernels: for the
// BB query rows q0.. (tiles q_s, do_s; lse_s, delta_s) against the BB
// keys k0.. (k_s, v_s): S = Q K^T, P = the guarded exp(S scale - lse)
// into p_s rounded to IT, dP = dO V^T, dS = P (dP - D) scale (from the
// f32 P) into ds_s rounded to IT; both [BB queries][BB + 1].
template <typename IT, int BB>
__device__ __forceinline__ void pair_ds(const float* q_s, const float* k_s,
                                        const float* v_s, const float* do_s,
                                        int ld, const float* lse_s,
                                        const float* delta_s, float* p_s,
                                        float* ds_s, int q0, int k0,
                                        const Geometry& g) {
  constexpr int R = BB / 16, ldp = BB + 1;
  float s[R][R], dp[R][R];
  zero(s);
  zero(dp);
  product(q_s, ld, 1, k_s, 1, ld, g.D, s);
  product(do_s, ld, 1, v_s, 1, ld, g.D, dp);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = out_row(i), c = out_col(j);
      const float lse = lse_s[r];
      const float score =
          visible(q0 + r, k0 + c, g) ? __fmul_rn(s[i][j], g.scale) : kNegInf;
      const float p =
          lse > kNegInf * 0.5f ? expf(__fsub_rn(score, lse)) : 0.f;
      p_s[r * ldp + c] = round_to<IT>(p);
      ds_s[r * ldp + c] = round_to<IT>(
          __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], delta_s[r])), g.scale));
    }
}

// the last k-block (of BB keys) that q-block qi sees; -1 for none
template <int BB>
__device__ __forceinline__ int last_kblock(int qi, const Geometry& g) {
  const int last = (g.Tk - 1) / BB;
  if (!g.causal) return last;
  const int reach = qi * BB + BB - 1 + g.offset;
  return reach < 0 ? -1 : min(last, reach / BB);
}

// whether k-block ki holds a key visible to some row of q-block qi
template <int BB>
__device__ __forceinline__ bool block_visible(int qi, int ki,
                                              const Geometry& g) {
  return !g.causal || ki * BB <= qi * BB + BB - 1 + g.offset;
}

// shared memory of the backward kernels, in floats: four Dp-wide tiles,
// P and dS, lse and D
template <int NC, int BB>
constexpr size_t bwd_floats() {
  return 4 * static_cast<size_t>(BB) * (32 * NC + 1) +
         2 * static_cast<size_t>(BB) * (BB + 1) + 2 * BB;
}

// Split dQ: one block per (b*h, q-block of BB rows), k-blocks innermost;
// dQ += dS K one whole block product at a time, in k order. dq [B, Tq, H,
// D] in IT.
template <typename IT, int NC, int BB>
__global__ void __launch_bounds__(kThreads, 1)
flash_general_dq_kernel(const IT* __restrict__ q, const IT* __restrict__ k,
                        const IT* __restrict__ v,
                        const IT* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        IT* __restrict__ dq, const Geometry g) {
  constexpr int Dp = 32 * NC, ld = Dp + 1, ldp = BB + 1;
  constexpr int RM = BB / 16, CN = Dp / 16;
  const int bh = blockIdx.x, qi = blockIdx.y;
  const int b = bh / g.H, h = bh - b * g.H;
  const int q0 = qi * BB;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BB * ld;
  float* k_s = do_s + BB * ld;
  float* v_s = k_s + BB * ld;
  float* p_s = v_s + BB * ld;
  float* ds_s = p_s + BB * ldp;
  float* lse_s = ds_s + BB * ldp;
  float* delta_s = lse_s + BB;

  load_tile(q_s, ld, BB, Dp, q, b, h, q0, g.Tq, g.H, g.D);
  load_tile(do_s, ld, BB, Dp, dout, b, h, q0, g.Tq, g.H, g.D);
  load_stat(lse_s, BB, lse, bh, q0, g.Tq, kNegInf);
  load_stat(delta_s, BB, delta, bh, q0, g.Tq, 0.f);
  float acc[RM][CN];
  zero(acc);
  const int last = last_kblock<BB>(qi, g);
  for (int ki = 0; ki <= last; ++ki) {
    const int k0 = ki * BB;
    __syncthreads();
    load_tile(k_s, ld, BB, Dp, k, b, h, k0, g.Tk, g.H, g.D);
    load_tile(v_s, ld, BB, Dp, v, b, h, k0, g.Tk, g.H, g.D);
    __syncthreads();
    pair_ds<IT, BB>(q_s, k_s, v_s, do_s, ld, lse_s, delta_s, p_s, ds_s, q0,
                    k0, g);
    __syncthreads();
    float blk[RM][CN];
    zero(blk);
    product(ds_s, ldp, 1, k_s, ld, 1, BB, blk);
    add(acc, blk);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = q0 + out_row(i);
    if (t >= g.Tq) continue;
#pragma unroll
    for (int j = 0; j < CN; ++j)
      if (out_col(j) < g.D)
        dq[row_at(b, t, h, g.Tq, g.H, g.D) + out_col(j)] =
            from_float<IT>(acc[i][j]);
  }
}

// Split dK/dV (FUSED = false) or the one-pass backward (FUSED = true): one
// block per (b*h, k-block of BB rows), q-blocks innermost; dV += P^T dO and
// dK += dS^T Q one whole block product at a time, in q order. The fused
// kernel also writes each pair's dS K to dqp [nk, B, Tq, H, D] (f32), and
// exact zeros for the pairs that causality skips.
template <typename IT, int NC, int BB, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1)
flash_general_kv_kernel(const IT* __restrict__ q, const IT* __restrict__ k,
                        const IT* __restrict__ v,
                        const IT* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        IT* __restrict__ dk, IT* __restrict__ dv,
                        float* __restrict__ dqp, const Geometry g) {
  constexpr int Dp = 32 * NC, ld = Dp + 1, ldp = BB + 1;
  constexpr int RM = BB / 16, CN = Dp / 16;
  const int bh = blockIdx.x, ki = blockIdx.y;
  const int b = bh / g.H, h = bh - b * g.H;
  const int k0 = ki * BB;
  const int nq = (g.Tq + BB - 1) / BB;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BB * ld;
  float* q_s = v_s + BB * ld;
  float* do_s = q_s + BB * ld;
  float* p_s = do_s + BB * ld;
  float* ds_s = p_s + BB * ldp;
  float* lse_s = ds_s + BB * ldp;
  float* delta_s = lse_s + BB;

  load_tile(k_s, ld, BB, Dp, k, b, h, k0, g.Tk, g.H, g.D);
  load_tile(v_s, ld, BB, Dp, v, b, h, k0, g.Tk, g.H, g.D);
  float dk_acc[RM][CN], dv_acc[RM][CN];
  zero(dk_acc);
  zero(dv_acc);
  for (int qi = 0; qi < nq; ++qi) {
    const int q0 = qi * BB;
    if (!block_visible<BB>(qi, ki, g)) {
      if (FUSED)
        for (int i = threadIdx.x; i < BB * g.D; i += kThreads) {
          const int t = q0 + i / g.D;
          if (t < g.Tq)
            dqp[row_at(ki * g.B + b, t, h, g.Tq, g.H, g.D) + i % g.D] = 0.f;
        }
      continue;
    }
    __syncthreads();
    load_tile(q_s, ld, BB, Dp, q, b, h, q0, g.Tq, g.H, g.D);
    load_tile(do_s, ld, BB, Dp, dout, b, h, q0, g.Tq, g.H, g.D);
    load_stat(lse_s, BB, lse, bh, q0, g.Tq, kNegInf);
    load_stat(delta_s, BB, delta, bh, q0, g.Tq, 0.f);
    __syncthreads();
    pair_ds<IT, BB>(q_s, k_s, v_s, do_s, ld, lse_s, delta_s, p_s, ds_s, q0,
                    k0, g);
    __syncthreads();
    float blk[RM][CN];
    zero(blk);
    product(p_s, 1, ldp, do_s, ld, 1, BB, blk);  // P^T dO
    add(dv_acc, blk);
    zero(blk);
    product(ds_s, 1, ldp, q_s, ld, 1, BB, blk);  // dS^T Q
    add(dk_acc, blk);
    if (FUSED) {
      zero(blk);
      product(ds_s, ldp, 1, k_s, ld, 1, BB, blk);  // dS K
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int t = q0 + out_row(i);
        if (t >= g.Tq) continue;
#pragma unroll
        for (int j = 0; j < CN; ++j)
          if (out_col(j) < g.D)
            dqp[row_at(ki * g.B + b, t, h, g.Tq, g.H, g.D) + out_col(j)] =
                blk[i][j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = k0 + out_row(i);
    if (t >= g.Tk) continue;
#pragma unroll
    for (int j = 0; j < CN; ++j)
      if (out_col(j) < g.D) {
        const size_t at = row_at(b, t, h, g.Tk, g.H, g.D) + out_col(j);
        dk[at] = from_float<IT>(dk_acc[i][j]);
        dv[at] = from_float<IT>(dv_acc[i][j]);
      }
  }
}

// ---- host -------------------------------------------------------------------

// the backward's block rows at padded width Dp: four Dp-wide tiles of 64
// rows fit up to Dp 128, of 32 rows above it (ops/attention.py
// `general_block`)
__host__ __device__ constexpr int bwd_block(int nc) {
  return nc <= 4 ? 64 : 32;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename IT, int NC>
cudaError_t forward(const void* q, const Segments& segs, void* out,
                    float* lse, const Geometry& g, cudaStream_t stream) {
  constexpr int ld = 32 * NC + 1;
  const size_t smem =
      (3 * kKeys * ld + kKeys * (kKeys + 1) + 3 * kKeys) * sizeof(float);
  auto kernel = flash_general_fwd_kernel<IT, NC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(g.B * g.H, (g.Tq + kKeys - 1) / kKeys);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const IT*>(q),
                                           static_cast<IT*>(out), lse, segs,
                                           g);
  return cudaGetLastError();
}

template <typename IT, int NC>
cudaError_t backward(int kind, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, void* dk, void* dv, float* dqp,
                     const Geometry& g, cudaStream_t stream) {
  constexpr int BB = bwd_block(NC);
  const size_t smem = bwd_floats<NC, BB>() * sizeof(float);
  const IT* q_ = static_cast<const IT*>(q);
  const IT* k_ = static_cast<const IT*>(k);
  const IT* v_ = static_cast<const IT*>(v);
  const IT* do_ = static_cast<const IT*>(dout);
  cudaError_t err;
  if (kind == 0) {
    auto kernel = flash_general_dq_kernel<IT, NC, BB>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid(g.B * g.H, (g.Tq + BB - 1) / BB);
    kernel<<<grid, kThreads, smem, stream>>>(q_, k_, v_, do_, lse, delta,
                                             static_cast<IT*>(dq), g);
  } else {
    auto kernel = kind == 1 ? flash_general_kv_kernel<IT, NC, BB, false>
                            : flash_general_kv_kernel<IT, NC, BB, true>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid(g.B * g.H, (g.Tk + BB - 1) / BB);
    kernel<<<grid, kThreads, smem, stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<IT*>(dk),
        static_cast<IT*>(dv), dqp, g);
  }
  return cudaGetLastError();
}

// The padded widths built: Dp = 32 NC for NC in {1, 2, 3, 4, 6, 8}; a D
// takes the smallest that holds it.
int padded_nc(int D) {
  const int nc = (D + 31) / 32;
  return nc <= 4 ? nc : (nc <= 6 ? 6 : 8);
}

template <typename IT>
cudaError_t forward_at(int nc, const void* q, const Segments& segs,
                       void* out, float* lse, const Geometry& g,
                       cudaStream_t s) {
  switch (nc) {
    case 1: return forward<IT, 1>(q, segs, out, lse, g, s);
    case 2: return forward<IT, 2>(q, segs, out, lse, g, s);
    case 3: return forward<IT, 3>(q, segs, out, lse, g, s);
    case 4: return forward<IT, 4>(q, segs, out, lse, g, s);
    case 6: return forward<IT, 6>(q, segs, out, lse, g, s);
    case 8: return forward<IT, 8>(q, segs, out, lse, g, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename IT>
cudaError_t backward_at(int nc, int kind, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* dq, void* dk, void* dv,
                        float* dqp, const Geometry& g, cudaStream_t s) {
  switch (nc) {
#define FLASHY_GENERAL_CASE(N)                                              \
  case N:                                                                   \
    return backward<IT, N>(kind, q, k, v, dout, lse, delta, dq, dk, dv, dqp, \
                           g, s);
    FLASHY_GENERAL_CASE(1)
    FLASHY_GENERAL_CASE(2)
    FLASHY_GENERAL_CASE(3)
    FLASHY_GENERAL_CASE(4)
    FLASHY_GENERAL_CASE(6)
    FLASHY_GENERAL_CASE(8)
#undef FLASHY_GENERAL_CASE
    default: return cudaErrorInvalidValue;
  }
}

bool valid(int dtype, int B, int H, int Tq, int Tk, int D) {
  return (dtype == 0 || dtype == 1) && B >= 1 && H >= 1 && Tq >= 1 &&
         Tk >= 1 && D >= 1 && D <= kMaxDim &&
         static_cast<long long>(B) * H <= 0x7fffffffLL &&
         (Tq + 31) / 32 <= 65535 && (Tk + 31) / 32 <= 65535;
}

}  // namespace

// The forward over n key segments (k[i], v[i]: [B, Tk, H, D] each; the
// flash forward passes one, the ring forward one per visible ring step
// in ring order), segment 0 causal where `causal0`, bottom-right at
// offset Tk - Tq. dtype: 0 f32, 1 bf16. q, out [B, Tq, H, D]; lse [B, H,
// Tq] f32. Returns a cudaError_t (0 = launched).
extern "C" int flashy_flash_general_forward(int dtype, const void* q,
                                            const void* const* k,
                                            const void* const* v, int n,
                                            int causal0, void* out,
                                            float* lse, int B, int H, int Tq,
                                            int Tk, int D, float scale,
                                            void* stream) {
  if (!valid(dtype, B, H, Tq, Tk, D) || n < 1 || n > kMaxSegments)
    return static_cast<int>(cudaErrorInvalidValue);
  Segments segs{};
  for (int i = 0; i < n; ++i) {
    if (k[i] == nullptr || v[i] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    segs.k[i] = k[i];
    segs.v[i] = v[i];
  }
  segs.n = n;
  segs.causal0 = causal0 ? 1 : 0;
  const Geometry g{B, H, Tq, Tk, D, Tk - Tq, segs.causal0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = padded_nc(D);
  return static_cast<int>(
      dtype == 0 ? forward_at<float>(nc, q, segs, out, lse, g, s)
                 : forward_at<__nv_bfloat16>(nc, q, segs, out, lse, g, s));
}

// kind: 0 split dQ (writes dq), 1 split dK/dV (dk, dv), 2 fused (dk, dv
// and the f32 dQ partials [nk, B, Tq, H, D] into dqp, nk = ceil(Tk /
// `flashy_flash_general_block(D)`), which the caller folds in k order).
// Returns a cudaError_t (0 = launched).
extern "C" int flashy_flash_general_backward(
    int kind, int dtype, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dq,
    void* dk, void* dv, float* dqp, int B, int H, int Tq, int Tk, int D,
    int causal, float scale, void* stream) {
  if (kind < 0 || kind > 2 || !valid(dtype, B, H, Tq, Tk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{B, H, Tq, Tk, D, Tk - Tq, causal ? 1 : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = padded_nc(D);
  return static_cast<int>(
      dtype == 0
          ? backward_at<float>(nc, kind, q, k, v, dout, lse, delta, dq, dk, dv,
                               dqp, g, s)
          : backward_at<__nv_bfloat16>(nc, kind, q, k, v, dout, lse, delta, dq,
                                       dk, dv, dqp, g, s));
}

// rows of the backward's blocks at head_dim D (64 up to a padded width of
// 128, 32 above it): the fused kernel's dQ partials are per this many keys
extern "C" int flashy_flash_general_block(int D) {
  return bwd_block(padded_nc(D));
}
