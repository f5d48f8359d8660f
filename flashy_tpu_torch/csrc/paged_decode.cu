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
//   * scores q.k * 1/sqrt(Dh) in f32; int8 pools multiply the K scale
//     into the scores before the softmax and the V scale into the probs
//     after it, each exactly once;
//   * an online softmax (running max, normalizer, f32 accumulator) with
//     the guarded exp: probabilities are zero while the running max is
//     still <= NEG_INF/2, so a row with no visible key outputs zero;
//   * P rounded to V's dtype before P.V for model-dtype pools; for int8
//     pools P*v_scale rounded to q's dtype against the payload cast to
//     q's dtype (exact: |payload| <= 127);
//   * out = acc / max(l, 1e-30), cast to q's dtype.
//
// What bounds it on this card: device-memory bytes. A decode step reads
// every live K/V row of every slot (plus the int8 scales, q and out)
// and does ~4 flops per K/V element, far below the ~295 flops/byte at
// which the H100's tensor cores would be the limit. The design's answer
// is to read each live block once, straight from the pool through the
// table, and to materialize no gathered logical view: one thread block
// per (slot, head) walks the table entries 0..last, where
// last = min((base+T-1)/bs, E-1), so a short slot in a long table pays
// for its live blocks only (the TPU kernel's index-map clamp and
// `pl.when` skip). The TPU grid's sequential entry axis becomes this
// loop. Consecutive entries are loaded and scored a tile of up to
// kTileKeys keys at a time to amortize the block-wide barriers, but the
// online softmax still steps ENTRY BY ENTRY inside the tile (one warp
// per query row, lanes over the entry's keys): the running max, the
// rounding of P and the rescale of the accumulator happen at the same
// points as in `_fused_body`, so bf16 results match it, not merely come
// close. Tensor cores, TMA and a split-K (flash-decoding) pass for T=1
// are later work; this version is plain FMA arithmetic from shared
// memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 64;        // keys per tile when blocks are small
constexpr int kMaxQueries = 64;      // T bound (decode, verify k+1, chunk)
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

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

// QT: q / out dtype. KVT: pool payload dtype (QT itself, or int8 when
// QUANT). Grid: (heads, slots). Layouts: q, out [B, T, H, Dh];
// k, v [N, bs, H, Dh]; k_scale, v_scale [N, bs, H]; table [B, E];
// base [B].
template <typename QT, typename KVT, bool QUANT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ k,
                    const KVT* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ base_pos,
                    QT* __restrict__ out, int T, int H, int Dh, int E,
                    int bs, int tile_entries, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ld = Dh + 1;  // padded rows: no bank conflicts across keys
  const int tile = tile_entries * bs;

  extern __shared__ float smem[];
  float* q_s = smem;              // [T][ld]
  float* k_s = q_s + T * ld;      // [tile][ld]
  float* v_s = k_s + tile * ld;   // [tile][ld]
  float* p_s = v_s + tile * ld;   // [T][tile] scores, then probs
  float* acc = p_s + T * tile;    // [T][Dh]
  float* m_s = acc + T * Dh;      // [T] running max
  float* l_s = m_s + T;           // [T] normalizer
  float* a_s = l_s + T;           // [T][tile_entries] per-entry rescale
  float* ks_s = a_s + T * tile_entries;  // [tile] K scales
  float* vs_s = ks_s + tile;      // [tile] V scales

  const int base = base_pos[b];
  const int* row = table + static_cast<size_t>(b) * E;
  for (int i = tid; i < T * Dh; i += kThreads) {
    const int t = i / Dh, d = i - t * Dh;
    q_s[t * ld + d] =
        to_float(q[(static_cast<size_t>(b * T + t) * H + h) * Dh + d]);
    acc[i] = 0.f;
  }
  for (int t = tid; t < T; t += kThreads) {
    m_s[t] = kNegInf;
    l_s[t] = 0.f;
  }
  int last = max(base + T - 1, 0) / bs;
  if (last > E - 1) last = E - 1;
  __syncthreads();

  for (int e0 = 0; e0 <= last; e0 += tile_entries) {
    const int n_entries = min(tile_entries, last - e0 + 1);
    const int keys = n_entries * bs;
    // K/V tile: key j of the tile is row j % bs of entry e0 + j / bs
    for (int i = tid; i < keys * Dh; i += kThreads) {
      const int j = i / Dh, d = i - j * Dh;
      const size_t blk = static_cast<size_t>(row[e0 + j / bs]);
      const size_t src = ((blk * bs + j % bs) * H + h) * Dh + d;
      k_s[j * ld + d] = to_float(k[src]);
      v_s[j * ld + d] = to_float(v[src]);
    }
    if (QUANT) {
      for (int j = tid; j < keys; j += kThreads) {
        const size_t blk = static_cast<size_t>(row[e0 + j / bs]);
        const size_t src = (blk * bs + j % bs) * H + h;
        ks_s[j] = k_scale[src];
        vs_s[j] = v_scale[src];
      }
    }
    __syncthreads();

    // scores, masked: key position e0*bs + j against query base + t
    for (int i = tid; i < T * keys; i += kThreads) {
      const int t = i / keys, j = i - t * keys;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s = fmaf(q_s[t * ld + d], k_s[j * ld + d], s);
      s *= scale;
      if (QUANT) s *= ks_s[j];
      p_s[t * tile + j] = (e0 * bs + j <= base + t) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax, entry by entry as `_fused_body` steps it: one warp
    // per query row, lanes over the entry's keys; probs overwrite the
    // scores, each entry's rescale factor goes to a_s
    const int lane = tid & 31;
    for (int t = tid >> 5; t < T; t += kWarps) {
      float* p_row = p_s + t * tile;
      float m_prev = m_s[t];
      float l = l_s[t];
      for (int ei = 0; ei < n_entries; ++ei) {
        float* p_blk = p_row + ei * bs;
        float blk_max = kNegInf;
        for (int j = lane; j < bs; j += 32) blk_max = fmaxf(blk_max, p_blk[j]);
        for (int o = 16; o > 0; o >>= 1)
          blk_max = fmaxf(blk_max, __shfl_xor_sync(0xffffffffu, blk_max, o));
        const float m_new = fmaxf(m_prev, blk_max);
        const bool live = m_new > kNegInf * 0.5f;
        float sum = 0.f;
        for (int j = lane; j < bs; j += 32) {
          const float p = live ? expf(p_blk[j] - m_new) : 0.f;
          sum += p;
          p_blk[j] = round_to<QT>(QUANT ? p * vs_s[ei * bs + j] : p);
        }
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float alpha = expf(m_prev - m_new);
        l = l * alpha + sum;
        m_prev = m_new;
        if (lane == 0) a_s[t * tile_entries + ei] = alpha;
      }
      if (lane == 0) {
        m_s[t] = m_prev;
        l_s[t] = l;
      }
    }
    __syncthreads();

    for (int i = tid; i < T * Dh; i += kThreads) {
      const int t = i / Dh, d = i - t * Dh;
      const float* p_row = p_s + t * tile;
      const float* alpha = a_s + t * tile_entries;
      float a = acc[i];
      for (int ei = 0; ei < n_entries; ++ei) {
        float pv = 0.f;
        for (int j = ei * bs; j < (ei + 1) * bs; ++j)
          pv = fmaf(p_row[j], v_s[j * ld + d], pv);
        a = a * alpha[ei] + pv;
      }
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < T * Dh; i += kThreads) {
    const int t = i / Dh, d = i - t * Dh;
    const float denom = fmaxf(l_s[t], 1e-30f);
    out[(static_cast<size_t>(b * T + t) * H + h) * Dh + d] =
        from_float<QT>(acc[i] / denom);
  }
}

template <typename QT, typename KVT, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const int* table, const int* base, void* out, int B,
                   int T, int H, int Dh, int E, int bs, float scale,
                   cudaStream_t stream) {
  const int tile_entries = bs >= kTileKeys ? 1 : kTileKeys / bs;
  const int tile = tile_entries * bs;
  const int ld = Dh + 1;
  const size_t floats = static_cast<size_t>(T) * ld + 2 * tile * ld +
                        static_cast<size_t>(T) * tile +
                        static_cast<size_t>(T) * Dh + 2 * T +
                        static_cast<size_t>(T) * tile_entries + 2 * tile;
  const size_t smem = floats * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<QT, KVT, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), table, base,
      static_cast<QT*>(out), T, H, Dh, E, bs, tile_entries, scale);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 f32 pools, 1 bf16 pools, 2 int8 pools with f32 q,
// 3 int8 pools with bf16 q. Returns a cudaError_t (0 = launched).
extern "C" int flashy_paged_decode(int variant, const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const int* table,
                                   const int* base, void* out, int B, int T,
                                   int H, int Dh, int E, int bs, float scale,
                                   void* stream) {
  if (B < 1 || T < 1 || T > kMaxQueries || H < 1 || Dh < 1 || E < 1 ||
      bs < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return launch<float, float, false>(q, k, v, k_scale, v_scale, table,
                                         base, out, B, T, H, Dh, E, bs,
                                         scale, s);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16, false>(
          q, k, v, k_scale, v_scale, table, base, out, B, T, H, Dh, E, bs,
          scale, s);
    case 2:
      return launch<float, int8_t, true>(q, k, v, k_scale, v_scale, table,
                                         base, out, B, T, H, Dh, E, bs,
                                         scale, s);
    case 3:
      return launch<__nv_bfloat16, int8_t, true>(
          q, k, v, k_scale, v_scale, table, base, out, B, T, H, Dh, E, bs,
          scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
