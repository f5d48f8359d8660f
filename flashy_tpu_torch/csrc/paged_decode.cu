// Paged-attention read for decode, speculative verify and chunked
// prefill on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of flashy_tpu/ops/paged_decode.py:
// `_fused_body` (the body of `_fused_kernel_dense` / `_fused_kernel_quant`)
// launched by `_fused_call`. It computes exactly what that body computes:
// for each slot b and head h, T query rows at the CONSECUTIVE positions
// base..base+T-1 (base = positions[b, 0]) attend the slot's paged K/V
// through its block table, with
//   * one mask, key position e*bs+j <= base+t (it also hides sentinel
//     and unassigned table entries, which only cover positions past the
//     slot's horizon), masked scores at NEG_INF = -1e30;
//   * only the live entries 0..last, last = min((base+T-1)/bs, E-1),
//     read and stepped (the TPU kernel's index-map clamp and `pl.when`
//     skip), so a short slot in a long table pays for its live blocks;
//   * scores q.k * 1/sqrt(Dh) in f32; int8 pools multiply the K scale
//     into the scores before the softmax and the V scale into the probs
//     after it, each exactly once;
//   * an online softmax stepped ENTRY BY ENTRY, as `_fused_body` steps
//     it: per table entry the running max, the guarded exp
//     (probabilities are zero while the running max is still <=
//     NEG_INF/2, so a row with no visible key outputs zero), the
//     normalizer l = l*alpha + sum(p), P rounded to V's dtype with that
//     entry's running max (int8 pools: P*v_scale rounded to q's dtype
//     against the payload cast to q's dtype, exact since |payload| <=
//     127), and acc = acc*alpha + P.V in entry order;
//   * out = acc / max(l, 1e-30), cast to q's dtype.
// One departure, in f32 only: with f32 q (variants 0 and 2) the chain
// (acc and l) is carried in f64. The TPU body's f32 chain drifts from
// the exact result by ~1.4e-5 over ~500 entries (bs 4, 2048 keys; the
// plain version 5.6e-6), past the 1e-5 bar the f32 kernel is held to;
// in f64 the kernel stays on the exact result. bf16 keeps the f32 chain
// and every rounding point of the TPU body.
//
// Shapes it takes: head_dim 64 (kDh; the port's 235M layout) and block
// sizes bs that are powers of two from 1 to 64 (a ring stage holds
// 64/bs whole entries), T <= 64, any number of slots, heads and table
// entries whose row fits in shared memory. The wrapper raises on
// anything else.
//
// What bounds it on this card: device-memory bytes. A read moves every
// live K/V row of its slot once (plus the int8 scales, q and out) and
// does ~4 flops per K/V element at T=1, far below the ~295 flops/byte
// at which the H100's tensor cores would be the limit; at the serving
// shapes (B 8, H 16, context ~192) that is ~6 MB, a ~2 us bound, so
// what it costs in practice is latency: dependent loads, idle warps and
// barriers. The design:
//   * one 256-thread block per (head, slot): 128 blocks at B 8, H 16,
//     one wave on 132 SMs. The slot's position, table row and q go to
//     shared memory in one round trip, each once;
//   * an asynchronous ring of kStages stages of 64 keys (whole table
//     entries), filled by 16-byte `cp.async` from all threads straight
//     from the pool through the table (rows past the live entries are
//     zero-filled, never read); kStages-1 stages are in flight while
//     one is scored, so a serving slot (~192 keys) is in flight at once;
//   * T = 1 (decode): every warp on units of at most 8 keys of one
//     entry (8 lanes per key, 16 bytes of a bf16 row each, reduced by
//     shuffles); a unit's max, then, once all are in, the running max
//     before and after its entry as a max over the earlier units (max
//     is exact, so any order gives the sequential value), its rounded
//     probabilities, its share of the entry's sum and its P.V partial
//     (lanes over d); the chain last, entry by entry;
//   * T >= 2: the stage's scores to shared memory, in bf16 by
//     `mma.sync.m16n8k16` (bf16 operands, f32 accumulation; int8
//     payloads cast to bf16 exactly), with f32 q by 8-lane FMA groups;
//     then one warp per query row steps the stage's entries (the
//     running max after each entry a prefix max over its keys, the
//     normalizer a short loop); then P.V per entry, in bf16 by
//     `mma.sync` from zero and acc*alpha + pv in registers, with f32 q
//     by FMA (TF32 would break the 1e-5 bar and the token-exact phase).
//     The f32 order inside an entry differs from the plain version; the
//     chain across entries does not.
// A split-K (flash-decoding) pass would move the rounding points, and
// 128 blocks already fill the card at the serving shapes: later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / 8;  // 8-lane groups, one key each
constexpr int kDh = 64;              // head_dim the kernel takes
constexpr int kStageKeys = 64;       // keys per ring stage
static_assert(kStageKeys / kWarps <= 8, "a T=1 unit holds at most 8 keys");
constexpr int kStages = 4;           // ring depth
constexpr int kMaxQueries = 64;      // T bound (decode, verify k+1, chunk)
constexpr int kLdq = kDh + 4;        // f32 q row, floats
constexpr int kLds = kStageKeys + 4; // f32 score / prob row, floats
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr unsigned kFull = 0xffffffffu;

// kDecode: T == 1, FMA. kFma: T >= 2 with f32 q. kMma: T >= 2 with
// bf16 q, the scores and P.V on the tensor cores.
enum Mode { kDecode = 0, kFma = 1, kMma = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 16-byte (8-bit payloads: 4-byte scales) async copies into shared
// memory; `live` false zero-fills the destination and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d = a(16x16, row) b(16x8, col) + d: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// eight payload values of a shared-memory row from element 8*i, as f32
__device__ __forceinline__ void load8(const unsigned char* row, int i,
                                      float* x, const float*) {
  const float4 a = reinterpret_cast<const float4*>(row)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(row)[2 * i + 1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const unsigned char* row, int i,
                                      float* x, const __nv_bfloat16*) {
  const uint4 u = reinterpret_cast<const uint4*>(row)[i];
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(p[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const unsigned char* row, int i,
                                      float* x, const int8_t*) {
  const uint2 u = reinterpret_cast<const uint2*>(row)[i];
  const int8_t* p = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = static_cast<float>(p[k]);
}

// q.k of one key by a group of 8 lanes, each on 8 of the 64 elements
// (q8: the lane's f32 q slice, kf: its payload slice), reduced by
// shuffles: every lane of the group returns the full product
__device__ __forceinline__ float group_dot(const float* q8, const float* kf) {
  const float4 a = reinterpret_cast<const float4*>(q8)[0];
  const float4 c = reinterpret_cast<const float4*>(q8)[1];
  float x = a.x * kf[0], y = c.x * kf[4];  // two chains: half the latency
  x = fmaf(a.y, kf[1], x);
  y = fmaf(c.y, kf[5], y);
  x = fmaf(a.z, kf[2], x);
  y = fmaf(c.z, kf[6], y);
  x = fmaf(a.w, kf[3], x);
  y = fmaf(c.w, kf[7], y);
  x += y;
  x += __shfl_xor_sync(kFull, x, 4);
  x += __shfl_xor_sync(kFull, x, 2);
  return x + __shfl_xor_sync(kFull, x, 1);
}

// two payload values (elements d, d+1; d even) of a shared-memory row,
// as f32, in one load
__device__ __forceinline__ float2 load2(const unsigned char* row, int d,
                                        const float*) {
  return *reinterpret_cast<const float2*>(row + 4 * d);
}
__device__ __forceinline__ float2 load2(const unsigned char* row, int d,
                                        const __nv_bfloat16*) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(row + 2 * d));
}
__device__ __forceinline__ float2 load2(const unsigned char* row, int d,
                                        const int8_t*) {
  const char2 c = *reinterpret_cast<const char2*>(row + d);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}
template <typename KVT>
__device__ __forceinline__ float2 load2(const unsigned char* row, int d) {
  return load2(row, d, static_cast<const KVT*>(nullptr));
}

// elements d, d+1 of a shared-memory row as a bf16 pair (exact for bf16
// and int8 payloads)
template <typename KVT>
__device__ __forceinline__ uint32_t pair_bf16(const unsigned char* row,
                                              int d) {
  if constexpr (sizeof(KVT) == 2) {
    return *reinterpret_cast<const uint32_t*>(row + 2 * d);
  } else {
    const float2 f = load2<KVT>(row, d);
    return pack_bf16(f.x, f.y);
  }
}

// one payload element of a shared-memory row as a bf16 bit pattern
template <typename KVT>
__device__ __forceinline__ uint32_t bits_bf16(const unsigned char* row,
                                              int d) {
  if constexpr (sizeof(KVT) == 2) {
    return reinterpret_cast<const unsigned short*>(row)[d];
  } else {
    return pack_bf16(to_float(reinterpret_cast<const KVT*>(row)[d]), 0.f) &
           0xffffu;
  }
}

// Shared-memory plan, in bytes from the start (host and device agree).
struct Plan {
  int row_bytes;     // one padded K or V row of a ring stage
  int stage_bytes;   // K and V of a stage
  int q, s, alpha, m, l, scales, unit, work, table, total;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Plan plan(int elem, bool quant, int mode, int T,
                                     int eps, int E) {
  Plan p;
  const int tq = mode == kMma ? (T + 15) & ~15 : T;
  p.row_bytes = kDh * elem + 16;  // 16 bytes of padding: no bank conflicts
  p.stage_bytes = 2 * kStageKeys * p.row_bytes;
  int at = kStages * p.stage_bytes;
  p.q = at;          at += align16(tq * kLdq * 4);          // f32 q rows
  p.s = at;          at += align16(tq * kLds * 4);          // scores, probs
  p.alpha = at;      at += align16(tq * eps * 4);           // per-entry rescale
  p.m = at;          at += align16(T * 4);                  // running max
  p.l = at;          at += align16(T * 8);                  // normalizer
  p.scales = at;     at += quant ? kStages * 2 * kStageKeys * 4 : 0;
  const int units = eps > kWarps ? eps : kWarps;
  p.unit = at;       // kDecode: each unit's max and sum
  at += mode == kDecode ? 2 * units * 4 : 0;
  p.work = at;       // kDecode: per-unit P.V partials; kFma: f64 acc
  at += mode == kDecode ? units * kDh * 4 : mode == kFma ? T * kDh * 8 : 0;
  p.table = at;      at += align16(E * 4);
  p.total = at;
  return p;
}

// QT: q / out dtype. KVT: pool payload dtype (QT itself, or int8 when
// QUANT). Grid: (heads, slots). Layouts: q [B, T, H, Dh] with element
// strides q_sb, q_st, q_sh (d contiguous); k, v [N, bs, H, Dh];
// k_scale, v_scale [N, bs, H]; table [B, E] int32; positions int64 with
// row stride pos_sb (its first column is each slot's base); out
// [B, T, H, Dh] contiguous.
template <typename QT, typename KVT, bool QUANT, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_kernel(const QT* __restrict__ q, long long q_sb,
                    long long q_st, long long q_sh,
                    const KVT* __restrict__ k, const KVT* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const long long* __restrict__ positions,
                    long long pos_sb, QT* __restrict__ out, int T, int H,
                    int E, int bs, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int eps = kStageKeys / bs;  // table entries per ring stage
  const Plan P = plan(sizeof(KVT), QUANT, MODE, T, eps, E);
  const int tq = MODE == kMma ? (T + 15) & ~15 : T;
  // the rescale chain's type: f64 for f32 q (see the note above)
  using Chain = typename std::conditional<sizeof(QT) == 4, double,
                                          float>::type;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + P.q);
  float* s_s = reinterpret_cast<float*>(smem + P.s);
  float* alpha_s = reinterpret_cast<float*>(smem + P.alpha);
  float* m_s = reinterpret_cast<float*>(smem + P.m);
  Chain* l_s = reinterpret_cast<Chain*>(smem + P.l);
  float* sc_s = reinterpret_cast<float*>(smem + P.scales);
  float* emax_s = reinterpret_cast<float*>(smem + P.unit);  // kDecode
  float* psum_s = emax_s + (eps > kWarps ? eps : kWarps);
  float* work = reinterpret_cast<float*>(smem + P.work);  // kDecode
  Chain* acc_s = reinterpret_cast<Chain*>(smem + P.work);  // kFma
  int* tab_s = reinterpret_cast<int*>(smem + P.table);

  // position, table row and q: one round trip, each read once
  const int base = static_cast<int>(positions[b * pos_sb]);
  const int* row = table + static_cast<size_t>(b) * E;
  for (int i = tid; i < E; i += kThreads) tab_s[i] = row[i];
  const QT* qb = q + b * q_sb + h * q_sh;
  for (int i = tid; i < tq * kDh; i += kThreads) {
    const int t = i / kDh, d = i - t * kDh;
    q_s[t * kLdq + d] = t < T ? to_float(qb[t * q_st + d]) : 0.f;
  }
  for (int t = tid; t < T; t += kThreads) {
    m_s[t] = kNegInf;
    l_s[t] = 0.f;
  }
  if (MODE == kFma)
    for (int i = tid; i < T * kDh; i += kThreads) acc_s[i] = 0.f;
  int last = max(base + T - 1, 0) / bs;
  if (last > E - 1) last = E - 1;
  const int n_stages = last / eps + 1;
  __syncthreads();

  // ring stage `stage` into its slot: K and V rows in 16-byte chunks
  // (consecutive threads on consecutive chunks of a row), the int8
  // scales in 4-byte copies; keys of entries past `last` zero-filled
  constexpr int kChunks = kDh * static_cast<int>(sizeof(KVT)) / 16;
  auto issue = [&](int stage) {
    if (stage < n_stages) {
      unsigned char* kb = smem + (stage % kStages) * P.stage_bytes;
      for (int c = tid; c < 2 * kStageKeys * kChunks; c += kThreads) {
        const int which = c / (kStageKeys * kChunks);
        const int r = (c / kChunks) % kStageKeys;
        const int ch = c % kChunks;
        const int e = stage * eps + r / bs;
        const bool live = e <= last;
        const size_t blk = live ? static_cast<size_t>(tab_s[e]) : 0;
        const KVT* src = (which ? v : k) +
                         ((blk * bs + r % bs) * H + h) * kDh +
                         ch * (16 / sizeof(KVT));
        cp_async16(kb + (which * kStageKeys + r) * P.row_bytes + ch * 16,
                   src, live);
      }
      if (QUANT) {
        float* sc = sc_s + (stage % kStages) * 2 * kStageKeys;
        for (int c = tid; c < 2 * kStageKeys; c += kThreads) {
          const int which = c / kStageKeys, r = c % kStageKeys;
          const int e = stage * eps + r / bs;
          const bool live = e <= last;
          const size_t blk = live ? static_cast<size_t>(tab_s[e]) : 0;
          cp_async4(sc + c, (which ? v_scale : k_scale) +
                                (blk * bs + r % bs) * H + h, live);
        }
      }
    }
    cp_async_commit();  // one group per stage, empty past the end
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  const int g = lane >> 2, c4 = lane & 3;  // mma fragment coordinates
  const int mtiles = tq / 16;
  Chain acc = 0.f, l_dec = 0.f;            // kDecode: out[0][tid], l
  float oacc[8][4];                        // kMma: this warp's O tiles
#pragma unroll
  for (int i = 0; i < 8; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s visible; stage s-1 done by every thread
    issue(s + kStages - 1);  // into stage s-1's slot
    const unsigned char* kb = smem + (s % kStages) * P.stage_bytes;
    const unsigned char* vb = kb + kStageKeys * P.row_bytes;
    const float* ks = sc_s + (s % kStages) * 2 * kStageKeys;
    const float* vs = ks + kStageKeys;
    const int e0 = s * eps;                 // first entry of the stage
    const int n_e = min(eps, last - e0 + 1);  // live entries in it
    const int key0 = e0 * bs;               // its first key position

    if (MODE == kDecode) {
      // T = 1. Units (entry, key subset) of at most 8 keys (span), a
      // warp each at a time, so that every warp works at any bs:
      //  A. the unit's scores (8 lanes per key, shuffle-reduced), masked
      //     and scaled, to s_s; the unit's share of its entry's max;
      //  B. once every unit's max is in: the running max before and
      //     after the unit's entry (a max over the earlier units: max is
      //     exact, so any order gives the sequential value), its
      //     probabilities, rounded with its entry's running max, its
      //     share of the entry's sum and its P.V partial;
      //  C. the chain, entry by entry: acc = acc*alpha + pv, l likewise.
      const int split = eps >= kWarps ? 1 : kWarps / eps;  // units/entry
      const int span = bs / split;                          // keys/unit
      const int units = n_e * split;
      const int grp = lane >> 3, sub = lane & 7;
      for (int u = warp; u < units; u += kWarps) {
        const int j0 = (u / split) * bs + (u % split) * span;
        float xs = kNegInf;  // lane l < span: key j0 + l
#pragma unroll
        for (int r = 0; r < (kStageKeys / kWarps + 3) / 4; ++r) {
          if (r * 4 >= span) break;  // warp-uniform
          const int j = j0 + min(grp + 4 * r, span - 1);
          float kf[8];
          load8(kb + j * P.row_bytes, sub, kf,
                static_cast<const KVT*>(nullptr));
          const float x = group_dot(q_s + 8 * sub, kf);
          // key l = g + 4r sits in group g: lane l takes it from lane 8g
          const float got = __shfl_sync(kFull, x, (lane & 3) * 8);
          if (lane / 4 == r) xs = got;
        }
        if (lane < span) {
          float sc = xs * scale;
          if (QUANT) sc *= ks[j0 + lane];
          xs = key0 + j0 + lane <= base ? sc : kNegInf;
          s_s[j0 + lane] = xs;
        } else {
          xs = kNegInf;
        }
        xs = fmaxf(xs, __shfl_xor_sync(kFull, xs, 4));
        xs = fmaxf(xs, __shfl_xor_sync(kFull, xs, 2));
        xs = fmaxf(xs, __shfl_xor_sync(kFull, xs, 1));
        if (lane == 0) emax_s[u] = xs;
      }
      __syncthreads();
      const float m_prev = m_s[0];
      for (int u = warp; u < units; u += kWarps) {
        const int e = u / split;
        const int j0 = e * bs + (u % split) * span;
        float m_old = m_prev;
#pragma unroll 4
        for (int w = 0; w < e * split; ++w) m_old = fmaxf(m_old, emax_s[w]);
        float m_new = m_old;
#pragma unroll 4
        for (int w = e * split; w < (e + 1) * split; ++w)
          m_new = fmaxf(m_new, emax_s[w]);
        const int l = min(lane, span - 1);
        const float p = lane < span && m_new > kNegInf * 0.5f
                            ? expf(s_s[j0 + l] - m_new) : 0.f;
        float pr;
        if constexpr (QUANT) {
          pr = round_to<QT>(p * vs[j0 + l]);
        } else {
          pr = round_to<KVT>(p);
        }
        float su = p + __shfl_xor_sync(kFull, p, 4);
        su += __shfl_xor_sync(kFull, su, 2);
        su += __shfl_xor_sync(kFull, su, 1);
        if (lane == 0) {
          psum_s[u] = su;
          if (u % split == 0) alpha_s[e] = expf(m_old - m_new);
        }
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i < span) {
            const float pj = __shfl_sync(kFull, pr, i);
            const float2 vv = load2<KVT>(vb + (j0 + i) * P.row_bytes,
                                         2 * lane);
            a0 = fmaf(pj, vv.x, a0);
            a1 = fmaf(pj, vv.y, a1);
          }
        }
        work[u * kDh + 2 * lane] = a0;
        work[u * kDh + 2 * lane + 1] = a1;
      }
      __syncthreads();
      if (tid < kDh) {  // l and the running max in every chain thread
        float m = m_prev;
#pragma unroll 4
        for (int e = 0; e < n_e; ++e) {
          const float al = alpha_s[e];
          float pv = work[e * split * kDh + tid];
          float su = psum_s[e * split];
          m = fmaxf(m, emax_s[e * split]);
          for (int part = 1; part < split; ++part) {
            pv += work[(e * split + part) * kDh + tid];
            su += psum_s[e * split + part];
            m = fmaxf(m, emax_s[e * split + part]);
          }
          acc = acc * al + pv;  // in Chain
          l_dec = l_dec * al + su;
        }
        if (tid == 0) m_s[0] = m;  // read again after the next barrier
      }
      continue;
    }

    // 1. raw scores q.k of the stage's 64 keys -> s_s
    if (MODE == kMma) {
      for (int i = warp; i < mtiles * (kStageKeys / 8); i += kWarps) {
        const int mt = i / (kStageKeys / 8), nt = i % (kStageKeys / 8);
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        const float* qa = q_s + (mt * 16 + g) * kLdq + 2 * c4;
        const unsigned char* kr = kb + (nt * 8 + g) * P.row_bytes;
#pragma unroll
        for (int kk = 0; kk < kDh / 16; ++kk) {
          const float* x = qa + kk * 16;
          mma_bf16(d, pack_bf16(x[0], x[1]),
                   pack_bf16(x[8 * kLdq], x[8 * kLdq + 1]),
                   pack_bf16(x[8], x[9]),
                   pack_bf16(x[8 * kLdq + 8], x[8 * kLdq + 9]),
                   pair_bf16<KVT>(kr, kk * 16 + 2 * c4),
                   pair_bf16<KVT>(kr, kk * 16 + 2 * c4 + 8));
        }
        float* sr = s_s + (mt * 16 + g) * kLds + nt * 8 + 2 * c4;
        sr[0] = d[0];
        sr[1] = d[1];
        sr[8 * kLds] = d[2];
        sr[8 * kLds + 1] = d[3];
      }
    } else {
      // groups of 8 lanes, one key each per step, lane i of a group on
      // elements 8i..8i+7
      const int grp = tid >> 3, sub = tid & 7;
#pragma unroll
      for (int r = 0; r < kStageKeys / kGroups; ++r) {
        const int j = grp + kGroups * r;
        float kf[8];
        load8(kb + j * P.row_bytes, sub, kf, static_cast<const KVT*>(nullptr));
        for (int t = 0; t < T; ++t) {
          const float x = group_dot(q_s + t * kLdq + 8 * sub, kf);
          if (sub == 0) s_s[t * kLds + j] = x;
        }
      }
    }
    __syncthreads();

    // 2. the stage's entries of the online softmax, one warp per query
    //    row, lanes over keys j = lane and lane + 32. Probabilities
    //    overwrite the scores; each entry's rescale factor goes to
    //    alpha_s.
    for (int t = warp; t < T; t += kWarps) {
      float* sr = s_s + t * kLds;
      const int qpos = base + t;
      float x[2], pre[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = lane + 32 * hf;
        float sc = sr[j] * scale;
        if (QUANT) sc *= ks[j];
        x[hf] = (j / bs < n_e && key0 + j <= qpos) ? sc : kNegInf;
        pre[hf] = x[hf];
      }
      // inclusive prefix max over the 64 keys in order
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y0 = __shfl_up_sync(kFull, pre[0], o);
        const float y1 = __shfl_up_sync(kFull, pre[1], o);
        if (lane >= o) {
          pre[0] = fmaxf(pre[0], y0);
          pre[1] = fmaxf(pre[1], y1);
        }
      }
      pre[1] = fmaxf(pre[1], __shfl_sync(kFull, pre[0], 31));
      const float m_prev = m_s[t];
      float p[2], al[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = lane + 32 * hf;
        const int first = (j / bs) * bs, end = first + bs - 1;
        // running max after this key's entry, and before it
        const float a_end = __shfl_sync(kFull, pre[0], end & 31);
        const float b_end = __shfl_sync(kFull, pre[1], end & 31);
        const int before = first > 0 ? first - 1 : 0;
        const float a_bef = __shfl_sync(kFull, pre[0], before & 31);
        const float b_bef = __shfl_sync(kFull, pre[1], before & 31);
        const float m_new = fmaxf(m_prev, end < 32 ? a_end : b_end);
        const float m_old =
            first > 0 ? fmaxf(m_prev, before < 32 ? a_bef : b_bef) : m_prev;
        p[hf] = m_new > kNegInf * 0.5f ? expf(x[hf] - m_new) : 0.f;
        al[hf] = expf(m_old - m_new);
        if constexpr (QUANT) {
          sr[j] = round_to<QT>(p[hf] * vs[j]);
        } else {
          sr[j] = round_to<KVT>(p[hf]);
        }
        if (j == first && j / bs < n_e) alpha_s[t * eps + j / bs] = al[hf];
      }
      // per-entry sums of the (unrounded) probabilities
      if (bs == 64) {
        p[0] += p[1];
        for (int o = 16; o > 0; o >>= 1)
          p[0] += __shfl_xor_sync(kFull, p[0], o);
        p[1] = p[0];
      } else {
        for (int o = bs / 2; o > 0; o >>= 1) {
          p[0] += __shfl_xor_sync(kFull, p[0], o);
          p[1] += __shfl_xor_sync(kFull, p[1], o);
        }
      }
      // the normalizer, entry by entry
      Chain l = l_s[t];
      for (int e = 0; e < n_e; ++e) {
        const int first = e * bs;
        const bool hi = first >= 32;
        const float a = __shfl_sync(kFull, hi ? al[1] : al[0], first & 31);
        const float su = __shfl_sync(kFull, hi ? p[1] : p[0], first & 31);
        l = l * a + su;
      }
      const float m_all = __shfl_sync(kFull, pre[1], 31);  // all 64 keys
      if (lane == 0) {
        m_s[t] = fmaxf(m_prev, m_all);
        l_s[t] = l;
      }
    }
    __syncthreads();

    // 3. P.V, entry by entry
    if (MODE == kFma) {
      for (int i = tid; i < T * kDh; i += kThreads) {
        const int t = i / kDh, d = i - t * kDh;
        const float* pr = s_s + t * kLds;
        const float* al = alpha_s + t * eps;
        Chain a = acc_s[i];
        for (int e = 0; e < n_e; ++e) {
          float pv = 0.f;
          for (int j = e * bs; j < (e + 1) * bs; ++j)
            pv = fmaf(pr[j],
                      to_float(reinterpret_cast<const KVT*>(
                          vb + j * P.row_bytes)[d]), pv);
          a = a * al[e] + pv;
        }
        acc_s[i] = a;
      }
    } else {
      // this warp's O tiles (mt, n8 column block of d), i = warp + 4*jt
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        const int i = warp + kWarps * jt;
        if (i < mtiles * (kDh / 8)) {
          const int mt = i / (kDh / 8), nd = i % (kDh / 8);
          const float* pa = s_s + (mt * 16 + g) * kLds + 2 * c4;
          for (int e = 0; e < n_e; ++e) {
            const int lo = e * bs, hi = lo + bs;  // the entry's keys
            float pv[4] = {0.f, 0.f, 0.f, 0.f};
            // P of the entry's keys only (a k16 step may hold several
            // entries when bs < 16)
            auto in = [&](int key) { return key >= lo && key < hi; };
            for (int kk = lo >> 4; kk * 16 < hi; ++kk) {
              const int k0 = kk * 16 + 2 * c4;  // keys k0, k0+1, +8, +9
              const float* x = pa + kk * 16;
              const bool i0 = in(k0), i1 = in(k0 + 1);
              const bool i8 = in(k0 + 8), i9 = in(k0 + 9);
              const uint32_t a0 =
                  pack_bf16(i0 ? x[0] : 0.f, i1 ? x[1] : 0.f);
              const uint32_t a1 = pack_bf16(i0 ? x[8 * kLds] : 0.f,
                                            i1 ? x[8 * kLds + 1] : 0.f);
              const uint32_t a2 =
                  pack_bf16(i8 ? x[8] : 0.f, i9 ? x[9] : 0.f);
              const uint32_t a3 = pack_bf16(i8 ? x[8 * kLds + 8] : 0.f,
                                            i9 ? x[8 * kLds + 9] : 0.f);
              const int col = nd * 8 + g;
              const uint32_t b0 =
                  bits_bf16<KVT>(vb + k0 * P.row_bytes, col) |
                  bits_bf16<KVT>(vb + (k0 + 1) * P.row_bytes, col) << 16;
              const uint32_t b1 =
                  bits_bf16<KVT>(vb + (k0 + 8) * P.row_bytes, col) |
                  bits_bf16<KVT>(vb + (k0 + 9) * P.row_bytes, col) << 16;
              mma_bf16(pv, a0, a1, a2, a3, b0, b1);
            }
            const int r0 = mt * 16 + g;
            const float al0 = alpha_s[r0 * eps + e];
            const float al1 = alpha_s[(r0 + 8) * eps + e];
            oacc[jt][0] = oacc[jt][0] * al0 + pv[0];
            oacc[jt][1] = oacc[jt][1] * al0 + pv[1];
            oacc[jt][2] = oacc[jt][2] * al1 + pv[2];
            oacc[jt][3] = oacc[jt][3] * al1 + pv[3];
          }
        }
      }
    }
  }
  __syncthreads();

  // out = acc / max(l, 1e-30) in q's dtype
  QT* ob = out + (static_cast<size_t>(b) * T * H + h) * kDh;
  const size_t ost = static_cast<size_t>(H) * kDh;  // out row stride
  if (MODE == kDecode) {
    if (tid < kDh) ob[tid] = from_float<QT>(acc / fmax(l_dec, Chain(1e-30f)));
  } else if (MODE == kFma) {
    for (int i = tid; i < T * kDh; i += kThreads) {
      const int t = i / kDh, d = i - t * kDh;
      ob[t * ost + d] =
          from_float<QT>(acc_s[i] / fmax(l_s[t], Chain(1e-30f)));
    }
  } else {
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      const int i = warp + kWarps * jt;
      if (i < mtiles * (kDh / 8)) {
        const int mt = i / (kDh / 8), nd = i % (kDh / 8);
        const int d = nd * 8 + 2 * c4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = mt * 16 + g + 8 * half;
          if (t < T) {
            const float inv = fmaxf(l_s[t], 1e-30f);
            ob[t * ost + d] = from_float<QT>(oacc[jt][2 * half] / inv);
            ob[t * ost + d + 1] = from_float<QT>(oacc[jt][2 * half + 1] / inv);
          }
        }
      }
    }
  }
}

template <typename QT, typename KVT, bool QUANT, int MODE>
cudaError_t launch(const void* q, long long q_sb, long long q_st,
                   long long q_sh, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const int* table, const long long* positions,
                   long long pos_sb, void* out, int B, int T, int H, int E,
                   int bs, float scale, cudaStream_t stream) {
  const Plan p = plan(sizeof(KVT), QUANT, MODE, T, kStageKeys / bs, E);
  if (static_cast<size_t>(p.total) > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<QT, KVT, QUANT, MODE>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<dim3(H, B), kThreads, p.total, stream>>>(
      static_cast<const QT*>(q), q_sb, q_st, q_sh,
      static_cast<const KVT*>(k), static_cast<const KVT*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      table, positions, pos_sb, static_cast<QT*>(out), T, H, E, bs, scale);
  return cudaGetLastError();
}

template <typename QT, typename KVT, bool QUANT>
cudaError_t dispatch(const void* q, long long q_sb, long long q_st,
                     long long q_sh, const void* k, const void* v,
                     const void* k_scale, const void* v_scale,
                     const int* table, const long long* positions,
                     long long pos_sb, void* out, int B, int T, int H,
                     int E, int bs, float scale, cudaStream_t stream) {
  constexpr bool kBf16Q = sizeof(QT) == 2;
  if (T == 1)
    return launch<QT, KVT, QUANT, kDecode>(
        q, q_sb, q_st, q_sh, k, v, k_scale, v_scale, table, positions,
        pos_sb, out, B, T, H, E, bs, scale, stream);
  return launch<QT, KVT, QUANT, kBf16Q ? kMma : kFma>(
      q, q_sb, q_st, q_sh, k, v, k_scale, v_scale, table, positions, pos_sb,
      out, B, T, H, E, bs, scale, stream);
}

}  // namespace

// variant: 0 f32 pools, 1 bf16 pools, 2 int8 pools with f32 q,
// 3 int8 pools with bf16 q. head_dim must be 64 and bs a power of two
// in [1, 64]. Returns a cudaError_t (0 = launched).
extern "C" int flashy_paged_decode(int variant, const void* q,
                                   long long q_sb, long long q_st,
                                   long long q_sh, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const int* table,
                                   const long long* positions,
                                   long long pos_sb, void* out, int B,
                                   int T, int H, int Dh, int E, int bs,
                                   float scale, void* stream) {
  if (B < 1 || T < 1 || T > kMaxQueries || H < 1 || Dh != kDh || E < 1 ||
      bs < 1 || bs > kStageKeys || (bs & (bs - 1)) != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return dispatch<float, float, false>(q, q_sb, q_st, q_sh, k, v,
                                           k_scale, v_scale, table,
                                           positions, pos_sb, out, B, T, H,
                                           E, bs, scale, s);
    case 1:
      return dispatch<__nv_bfloat16, __nv_bfloat16, false>(
          q, q_sb, q_st, q_sh, k, v, k_scale, v_scale, table, positions,
          pos_sb, out, B, T, H, E, bs, scale, s);
    case 2:
      return dispatch<float, int8_t, true>(q, q_sb, q_st, q_sh, k, v,
                                           k_scale, v_scale, table,
                                           positions, pos_sb, out, B, T, H,
                                           E, bs, scale, s);
    case 3:
      return dispatch<__nv_bfloat16, int8_t, true>(
          q, q_sb, q_st, q_sh, k, v, k_scale, v_scale, table, positions,
          pos_sb, out, B, T, H, E, bs, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
