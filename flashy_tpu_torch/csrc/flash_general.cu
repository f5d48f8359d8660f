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
// Any head_dim D, f32 or bf16. The wrappers pick this route by the shape
// and dtype (`ops/attention.py` `flash_route`).
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
// Design: the head dimension in slabs of Dp = 32 NC columns, Dp the
// smallest multiple of 32 that holds D up to 128, and 128 above it: ns =
// ceil(D / Dp) slabs (ops/attention.py `general_plan` computes the same).
// Tiles of 64 rows and one slab live in shared memory as f32 (bf16
// widened exactly), columns past D zero-filled on load, so the shared
// memory of a block is bounded whatever D is (at most ~116 KB forward,
// ~162 KB backward). The products over the head dimension (S = Q K^T,
// dP = dO V^T) run slab after slab into the same registers, each output
// one ascending FMA chain over the true D, as one product over the whole
// width would run it; the products over keys or queries (P V, dS K, P^T
// dO, dS^T Q) produce one slab of the output: the grid's third dimension
// is the output slab, and each of its blocks computes S, P and dS itself
// (ns times the score work, none of it shared). With one slab the
// resident side (Q in the forward and split dQ, K and V in dK/dV) is
// loaded once, as before slabs. 256 threads, a thread owning a
// (16-strided) RM x CN block of each product's output, every product an
// ascending FMA chain from shared memory (rows padded to an odd length:
// no bank conflicts along rows or columns). The fused kernel's dQ
// partials are per 64 keys.
//
// What bounds it on this card: operations (4 D flops a visible (query,
// key) pair forward, 10 D backward), at the bf16 tensor cores' rate for
// bf16 inputs. This route runs them as f32 FMAs from shared memory, about
// 1/15 of that rate at best: a simple kernel that is right. The bf16
// Hopper steps at other multiples of 16, and an f32 route on the tensor
// cores (as the grouped kernels' three-term bf16 split), are later work
// (ROADMAP, later kernel work). The fused kernel's partials take nk x the
// bytes of dQ, nk = Tk / 64, so they grow with T^2. Above one slab the
// score work is repeated per output slab: ~ns x the forward's and the
// backward's S and dP products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;       // rows of every tile (FLASH_BLOCK)
constexpr int kMaxNC = 4;       // the widest slab: 32 kMaxNC = 128 columns
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

// slabs of width Dp that hold D columns
__host__ __device__ __forceinline__ int slab_count(int D, int Dp) {
  return (D + Dp - 1) / Dp;
}

// columns col0..col0+Dp-1 of rows row0..row0+R-1 of head (b, h) of a [B,
// T, H, D] tensor into an f32 tile [R][ld]; rows past T and columns past
// D are zero
template <typename IT>
__device__ __forceinline__ void load_tile(float* dst, int ld, int R, int Dp,
                                          const IT* __restrict__ src, int b,
                                          int h, int row0, int col0, int T,
                                          int H, int D) {
  for (int i = threadIdx.x; i < R * Dp; i += kThreads) {
    const int r = i / Dp, d = i - r * Dp;
    const int t = row0 + r, c = col0 + d;
    dst[r * ld + d] = (t < T && c < D)
                          ? to_float(src[row_at(b, t, h, T, H, D) + c])
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

// One block per (b*h, 64 query rows, output slab z): the online softmax
// over every segment's keys, 64 at a time, S over all ns slabs of the head
// dimension and P.V into the columns of slab z. out [B, Tq, H, D] in IT,
// lse [B*H, Tq] (written by the blocks of slab 0).
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
  const int ns = slab_count(g.D, Dp), c0 = blockIdx.z * Dp;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [64][ld] a slab of Q
  float* k_s = q_s + kKeys * ld;     // [64][ld] a slab of K
  float* v_s = k_s + kKeys * ld;     // [64][ld] slab z of V
  float* p_s = v_s + kKeys * ld;     // [64][ldp] scores, then P
  float* m_s = p_s + kKeys * ldp;    // [64] running max
  float* l_s = m_s + kKeys;          // [64] normalizer
  float* a_s = l_s + kKeys;          // [64] this step's rescale
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (ns == 1) load_tile(q_s, ld, kKeys, Dp, q, b, h, q0, 0, g.Tq, g.H, g.D);
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
      float s[RM][RM];
      zero(s);
      for (int sl = 0; sl < ns; ++sl) {
        // the previous slab's product (at sl 0: the previous step's P.V)
        // is done with q_s, k_s, v_s and p_s
        __syncthreads();
        if (ns > 1)
          load_tile(q_s, ld, kKeys, Dp, q, b, h, q0, sl * Dp, g.Tq, g.H,
                    g.D);
        load_tile(k_s, ld, kKeys, Dp, k, b, h, k0, sl * Dp, g.Tk, g.H, g.D);
        if (sl == 0)
          load_tile(v_s, ld, kKeys, Dp, v, b, h, k0, c0, g.Tk, g.H, g.D);
        __syncthreads();
        product(q_s, ld, 1, k_s, 1, ld, min(Dp, g.D - sl * Dp), s);
      }
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
      const int c = c0 + out_col(j);
      if (c < g.D)
        out[row_at(b, t, h, g.Tq, g.H, g.D) + c] =
            from_float<IT>(__fdiv_rn(acc[i][j], denom));
    }
  }
  if (blockIdx.z != 0) return;
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

template <typename IT>
struct Operands {
  const IT* q;
  const IT* k;
  const IT* v;
  const IT* dout;
};

// The score products of the backward's pair step, shared by the three
// kernels: for the 64 query rows q0.. against the 64 keys k0.., S = Q K^T
// and dP = dO V^T, each output one ascending FMA chain over the head
// dimension, slab after slab. Every slab of the four tiles is loaded here
// where ns > 1; with one slab only the side that moves from pair to pair
// (K and V where `keys_move`, else Q and dO), the caller having loaded the
// other once. On return the tiles hold slab ns - 1.
template <typename IT, int NC, int R>
__device__ __forceinline__ void pair_scores(
    float* q_s, float* k_s, float* v_s, float* do_s, const Operands<IT>& op,
    int b, int h, int q0, int k0, int ns, bool keys_move, const Geometry& g,
    float (&s)[R][R], float (&dp)[R][R]) {
  constexpr int Dp = 32 * NC, ld = Dp + 1;
  zero(s);
  zero(dp);
  for (int sl = 0; sl < ns; ++sl) {
    const int c0 = sl * Dp;
    __syncthreads();  // the previous products are done with the tiles
    if (ns > 1 || !keys_move) {
      load_tile(q_s, ld, kKeys, Dp, op.q, b, h, q0, c0, g.Tq, g.H, g.D);
      load_tile(do_s, ld, kKeys, Dp, op.dout, b, h, q0, c0, g.Tq, g.H, g.D);
    }
    if (ns > 1 || keys_move) {
      load_tile(k_s, ld, kKeys, Dp, op.k, b, h, k0, c0, g.Tk, g.H, g.D);
      load_tile(v_s, ld, kKeys, Dp, op.v, b, h, k0, c0, g.Tk, g.H, g.D);
    }
    __syncthreads();
    const int L = min(Dp, g.D - c0);
    product(q_s, ld, 1, k_s, 1, ld, L, s);
    product(do_s, ld, 1, v_s, 1, ld, L, dp);
  }
}

// The rest of the pair step: P = the guarded exp(S scale - lse) into p_s
// rounded to IT, dS = P (dP - D) scale (from the f32 P) into ds_s rounded
// to IT; both [64 queries][65].
template <typename IT, int R>
__device__ __forceinline__ void pair_ds(const float (&s)[R][R],
                                        const float (&dp)[R][R],
                                        const float* lse_s,
                                        const float* delta_s, float* p_s,
                                        float* ds_s, int q0, int k0,
                                        const Geometry& g) {
  constexpr int ldp = kKeys + 1;
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

// the last k-block (of 64 keys) that q-block qi sees; -1 for none
__device__ __forceinline__ int last_kblock(int qi, const Geometry& g) {
  const int last = (g.Tk - 1) / kKeys;
  if (!g.causal) return last;
  const int reach = qi * kKeys + kKeys - 1 + g.offset;
  return reach < 0 ? -1 : min(last, reach / kKeys);
}

// whether k-block ki holds a key visible to some row of q-block qi
__device__ __forceinline__ bool block_visible(int qi, int ki,
                                              const Geometry& g) {
  return !g.causal || ki * kKeys <= qi * kKeys + kKeys - 1 + g.offset;
}

// Split dQ: one block per (b*h, q-block of 64 rows, output slab z),
// k-blocks innermost; dQ += dS K one whole block product at a time, in k
// order, into the columns of slab z. dq [B, Tq, H, D] in IT.
template <typename IT, int NC>
__global__ void __launch_bounds__(kThreads, 1)
flash_general_dq_kernel(const Operands<IT> op, const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        IT* __restrict__ dq, const Geometry g) {
  constexpr int Dp = 32 * NC, ld = Dp + 1, ldp = kKeys + 1;
  constexpr int RM = kKeys / 16, CN = Dp / 16;
  const int bh = blockIdx.x, qi = blockIdx.y;
  const int b = bh / g.H, h = bh - b * g.H;
  const int q0 = qi * kKeys;
  const int ns = slab_count(g.D, Dp), z = blockIdx.z, c0 = z * Dp;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kKeys * ld;
  float* k_s = do_s + kKeys * ld;
  float* v_s = k_s + kKeys * ld;
  float* p_s = v_s + kKeys * ld;
  float* ds_s = p_s + kKeys * ldp;
  float* lse_s = ds_s + kKeys * ldp;
  float* delta_s = lse_s + kKeys;

  if (ns == 1) {
    load_tile(q_s, ld, kKeys, Dp, op.q, b, h, q0, 0, g.Tq, g.H, g.D);
    load_tile(do_s, ld, kKeys, Dp, op.dout, b, h, q0, 0, g.Tq, g.H, g.D);
  }
  load_stat(lse_s, kKeys, lse, bh, q0, g.Tq, kNegInf);
  load_stat(delta_s, kKeys, delta, bh, q0, g.Tq, 0.f);
  float acc[RM][CN];
  zero(acc);
  const int last = last_kblock(qi, g);
  for (int ki = 0; ki <= last; ++ki) {
    const int k0 = ki * kKeys;
    float s[RM][RM], dp[RM][RM];
    pair_scores<IT, NC>(q_s, k_s, v_s, do_s, op, b, h, q0, k0, ns, true, g,
                        s, dp);
    pair_ds<IT>(s, dp, lse_s, delta_s, p_s, ds_s, q0, k0, g);
    if (z != ns - 1) {  // the tiles hold slab ns - 1: K's slab z back
      __syncthreads();
      load_tile(k_s, ld, kKeys, Dp, op.k, b, h, k0, c0, g.Tk, g.H, g.D);
    }
    __syncthreads();
    float blk[RM][CN];
    zero(blk);
    product(ds_s, ldp, 1, k_s, ld, 1, kKeys, blk);
    add(acc, blk);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = q0 + out_row(i);
    if (t >= g.Tq) continue;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int c = c0 + out_col(j);
      if (c < g.D)
        dq[row_at(b, t, h, g.Tq, g.H, g.D) + c] = from_float<IT>(acc[i][j]);
    }
  }
}

// Split dK/dV (FUSED = false) or the one-pass backward (FUSED = true): one
// block per (b*h, k-block of 64 rows, output slab z), q-blocks innermost;
// dV += P^T dO and dK += dS^T Q one whole block product at a time, in q
// order, into the columns of slab z. The fused kernel also writes each
// pair's dS K (slab z) to dqp [nk, B, Tq, H, D] (f32), and exact zeros for
// the pairs that causality skips.
template <typename IT, int NC, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1)
flash_general_kv_kernel(const Operands<IT> op, const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        IT* __restrict__ dk, IT* __restrict__ dv,
                        float* __restrict__ dqp, const Geometry g) {
  constexpr int Dp = 32 * NC, ld = Dp + 1, ldp = kKeys + 1;
  constexpr int RM = kKeys / 16, CN = Dp / 16;
  const int bh = blockIdx.x, ki = blockIdx.y;
  const int b = bh / g.H, h = bh - b * g.H;
  const int k0 = ki * kKeys;
  const int nq = (g.Tq + kKeys - 1) / kKeys;
  const int ns = slab_count(g.D, Dp), z = blockIdx.z, c0 = z * Dp;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kKeys * ld;
  float* q_s = v_s + kKeys * ld;
  float* do_s = q_s + kKeys * ld;
  float* p_s = do_s + kKeys * ld;
  float* ds_s = p_s + kKeys * ldp;
  float* lse_s = ds_s + kKeys * ldp;
  float* delta_s = lse_s + kKeys;

  if (ns == 1) {
    load_tile(k_s, ld, kKeys, Dp, op.k, b, h, k0, 0, g.Tk, g.H, g.D);
    load_tile(v_s, ld, kKeys, Dp, op.v, b, h, k0, 0, g.Tk, g.H, g.D);
  }
  float dk_acc[RM][CN], dv_acc[RM][CN];
  zero(dk_acc);
  zero(dv_acc);
  for (int qi = 0; qi < nq; ++qi) {
    const int q0 = qi * kKeys;
    if (!block_visible(qi, ki, g)) {
      if (FUSED)
        for (int i = threadIdx.x; i < kKeys * Dp; i += kThreads) {
          const int t = q0 + i / Dp, c = c0 + i % Dp;
          if (t < g.Tq && c < g.D)
            dqp[row_at(ki * g.B + b, t, h, g.Tq, g.H, g.D) + c] = 0.f;
        }
      continue;
    }
    // the last reads of lse_s and delta_s (pair_ds) are behind a barrier
    load_stat(lse_s, kKeys, lse, bh, q0, g.Tq, kNegInf);
    load_stat(delta_s, kKeys, delta, bh, q0, g.Tq, 0.f);
    float s[RM][RM], dp[RM][RM];
    pair_scores<IT, NC>(q_s, k_s, v_s, do_s, op, b, h, q0, k0, ns, false, g,
                        s, dp);
    pair_ds<IT>(s, dp, lse_s, delta_s, p_s, ds_s, q0, k0, g);
    if (z != ns - 1) {  // the tiles hold slab ns - 1: slab z back
      __syncthreads();
      load_tile(q_s, ld, kKeys, Dp, op.q, b, h, q0, c0, g.Tq, g.H, g.D);
      load_tile(do_s, ld, kKeys, Dp, op.dout, b, h, q0, c0, g.Tq, g.H, g.D);
      if (FUSED)
        load_tile(k_s, ld, kKeys, Dp, op.k, b, h, k0, c0, g.Tk, g.H, g.D);
    }
    __syncthreads();
    float blk[RM][CN];
    zero(blk);
    product(p_s, 1, ldp, do_s, ld, 1, kKeys, blk);  // P^T dO
    add(dv_acc, blk);
    zero(blk);
    product(ds_s, 1, ldp, q_s, ld, 1, kKeys, blk);  // dS^T Q
    add(dk_acc, blk);
    if (FUSED) {
      zero(blk);
      product(ds_s, ldp, 1, k_s, ld, 1, kKeys, blk);  // dS K
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int t = q0 + out_row(i);
        if (t >= g.Tq) continue;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int c = c0 + out_col(j);
          if (c < g.D)
            dqp[row_at(ki * g.B + b, t, h, g.Tq, g.H, g.D) + c] = blk[i][j];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = k0 + out_row(i);
    if (t >= g.Tk) continue;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int c = c0 + out_col(j);
      if (c < g.D) {
        const size_t at = row_at(b, t, h, g.Tk, g.H, g.D) + c;
        dk[at] = from_float<IT>(dk_acc[i][j]);
        dv[at] = from_float<IT>(dv_acc[i][j]);
      }
    }
  }
}

// ---- host -------------------------------------------------------------------

// shared memory of the kernels, in floats (ops/attention.py `general_plan`
// computes the same): the forward's Q, K and V slabs, P and the three row
// statistics; the backward's four slabs, P and dS, lse and D
template <int NC>
constexpr size_t fwd_floats() {
  return 3 * static_cast<size_t>(kKeys) * (32 * NC + 1) +
         static_cast<size_t>(kKeys) * (kKeys + 1) + 3 * kKeys;
}
template <int NC>
constexpr size_t bwd_floats() {
  return 4 * static_cast<size_t>(kKeys) * (32 * NC + 1) +
         2 * static_cast<size_t>(kKeys) * (kKeys + 1) + 2 * kKeys;
}
static_assert(bwd_floats<kMaxNC>() * sizeof(float) <= kMaxSmem,
              "the widest slab's backward block must fit");

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
  const size_t smem = fwd_floats<NC>() * sizeof(float);
  auto kernel = flash_general_fwd_kernel<IT, NC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(g.B * g.H, (g.Tq + kKeys - 1) / kKeys, slab_count(g.D, 32 * NC));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const IT*>(q),
                                           static_cast<IT*>(out), lse, segs,
                                           g);
  return cudaGetLastError();
}

template <typename IT, int NC>
cudaError_t backward(int kind, const Operands<IT>& op, const float* lse,
                     const float* delta, void* dq, void* dk, void* dv,
                     float* dqp, const Geometry& g, cudaStream_t stream) {
  const size_t smem = bwd_floats<NC>() * sizeof(float);
  const int ns = slab_count(g.D, 32 * NC);
  cudaError_t err;
  if (kind == 0) {
    auto kernel = flash_general_dq_kernel<IT, NC>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid(g.B * g.H, (g.Tq + kKeys - 1) / kKeys, ns);
    kernel<<<grid, kThreads, smem, stream>>>(op, lse, delta,
                                             static_cast<IT*>(dq), g);
  } else {
    auto kernel = kind == 1 ? flash_general_kv_kernel<IT, NC, false>
                            : flash_general_kv_kernel<IT, NC, true>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid(g.B * g.H, (g.Tk + kKeys - 1) / kKeys, ns);
    kernel<<<grid, kThreads, smem, stream>>>(
        op, lse, delta, static_cast<IT*>(dk), static_cast<IT*>(dv), dqp, g);
  }
  return cudaGetLastError();
}

// The slab width built for head dim D: Dp = 32 NC for NC in {1, 2, 3, 4},
// the smallest that holds D, 128 for every D above it.
int padded_nc(int D) {
  const int nc = (D + 31) / 32;
  return nc < kMaxNC ? nc : kMaxNC;
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
    default: return cudaErrorInvalidValue;
  }
}

template <typename IT>
cudaError_t backward_at(int nc, int kind, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* dq, void* dk, void* dv,
                        float* dqp, const Geometry& g, cudaStream_t s) {
  const Operands<IT> op{static_cast<const IT*>(q), static_cast<const IT*>(k),
                        static_cast<const IT*>(v),
                        static_cast<const IT*>(dout)};
  switch (nc) {
    case 1: return backward<IT, 1>(kind, op, lse, delta, dq, dk, dv, dqp, g, s);
    case 2: return backward<IT, 2>(kind, op, lse, delta, dq, dk, dv, dqp, g, s);
    case 3: return backward<IT, 3>(kind, op, lse, delta, dq, dk, dv, dqp, g, s);
    case 4: return backward<IT, 4>(kind, op, lse, delta, dq, dk, dv, dqp, g, s);
    default: return cudaErrorInvalidValue;
  }
}

bool valid(int dtype, int B, int H, int Tq, int Tk, int D) {
  return (dtype == 0 || dtype == 1) && B >= 1 && H >= 1 && Tq >= 1 &&
         Tk >= 1 && D >= 1 && static_cast<long long>(B) * H <= 0x7fffffffLL &&
         (Tq + kKeys - 1) / kKeys <= 65535 &&
         (Tk + kKeys - 1) / kKeys <= 65535 &&
         slab_count(D, 32 * padded_nc(D)) <= 65535;
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
// and the f32 dQ partials [nk, B, Tq, H, D] into dqp, nk = ceil(Tk / 64),
// which the caller folds in k order). Returns a cudaError_t (0 =
// launched).
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
