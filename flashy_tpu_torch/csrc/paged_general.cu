// Paged-attention read at every width: the general route of the paged
// read on Hopper (sm_90a).
//
// Replaces the same Pallas TPU kernel as paged_decode.cu, `_fused_body`
// of flashy_tpu/ops/paged_decode.py (the body of `_fused_kernel_dense` /
// `_fused_kernel_quant`, launched by `_fused_call`), for the shapes that
// kernel does not take: any head_dim and any block size.
// paged_decode.cu (head_dim 64, block sizes that are powers of two up to
// 64) keeps every other shape; the wrapper picks the
// route from the shape (`ops/paged_decode.py` `kernel_route`).
//
// It computes what the TPU body computes, with its rounding points, as
// paged_decode.cu does: for each slot b and head h, T <= 64 query rows
// at the CONSECUTIVE positions base..base+T-1 (base = positions[b, 0])
// attend the slot's paged K/V through its block table;
//   * one mask, key position e*bs+j <= base+t, masked scores at NEG_INF;
//   * only the live entries 0..last, last = min((base+T-1)/bs, E-1);
//   * scores q.k * 1/sqrt(Dh) in f32; int8 pools multiply the K scale
//     into the scores and the V scale into the probabilities;
//   * the online softmax stepped ENTRY BY ENTRY: per table entry the
//     running max, the guarded exp, l = l*alpha + sum(p), P rounded to
//     V's dtype (int8: P*v_scale rounded to q's dtype against the
//     payload cast to q's dtype), acc = acc*alpha + P.V, all with
//     non-contracted arithmetic;
//   * out = acc / max(l, 1e-30), cast to q's dtype.
// With f32 q the chain (acc and l) is carried in f64, as paged_decode.cu
// carries it (the TPU body's f32 chain drifts past the 1e-5 bar over
// hundreds of entries); bf16 keeps the f32 chain.
//
// Design: the first port's kernel, kept as the route for other widths. One
// 256-thread block per (head, slot, group of query rows) walks the live
// entries: q and the accumulator in shared memory, K and V through one
// 64-key buffer, the scores of at most 64 keys a row, so that shared
// memory depends on T and Dh and never on the block size
// (ops/paged_decode.py `general_smem_bytes`). Entries of up to 64 keys go
// a tile of whole entries at a time: K of the tile loaded and scored, V
// loaded into the same buffer while one warp per query row steps the
// tile's entries, then P.V per entry by FMA. An entry of more than 64 keys
// goes in two passes of 64-key chunks: the first scores each chunk for
// the entry's max; the second scores it again (the same FMA chains, so the
// same scores), takes exp, each lane's share of the sum (lane l adds keys
// l, l + 32, l + 64, ... in order, as one pass over the entry would) and
// the rounded P, loads the chunk's V and carries the P.V chain on in key
// order; the entry's rescale closes it. Every value is the one a single
// pass over the whole entry gives. The T rows go to one block where they
// fit in shared memory, else to as few groups of consecutive rows as fit
// (`rows_that_fit`): a row's chain steps the same entries in the same
// tiles either way (the entries past its own reach, which a group with
// later rows also steps, leave it exactly as it was: p = 0, alpha = 1),
// so the split changes no bit. What bounds it: as paged_decode.cu,
// device-memory bytes at the bound; in fact latency (plain loads, a block
// barrier per phase), and above 64 keys an entry's K is read twice. The
// `cp.async` ring and the tensor cores of paged_decode.cu at these widths
// are later work (ROADMAP, later kernel work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
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

// non-contracted a * b + c in the chain's precision
__device__ __forceinline__ float mul_add(float a, float b, float c) {
  return __fadd_rn(__fmul_rn(a, b), c);
}
__device__ __forceinline__ double mul_add(double a, double b, double c) {
  return __dadd_rn(__dmul_rn(a, b), c);
}

// the chain's type: f64 with f32 q, f32 with bf16 q
template <typename QT>
using Chain = typename std::conditional<std::is_same<QT, float>::value,
                                        double, float>::type;


// shared memory of one block of T query rows, in bytes (ops/paged_decode.py
// `general_smem_bytes` computes the same): the chain and its normalizer, q,
// K or V of 64 keys, the scores of 64 keys a row, the running max, the
// per-entry rescale, the scales of 64 keys, and for an entry past 64 keys
// the P.V partial sums, the lanes' partial sums and the entry's max
template <typename QT>
size_t smem_bytes(int T, int Dh) {
  const size_t ld = Dh + 1, rows = T;
  return sizeof(Chain<QT>) * (rows * Dh + rows) +
         sizeof(float) * (rows * ld + kTileKeys * ld + rows * kTileKeys +
                          rows + rows * kTileKeys + 2 * kTileKeys +
                          rows * Dh + rows * 32 + rows);
}

// the most query rows, up to T, whose block fits in shared memory; 0 where
// not even one row does
template <typename QT>
int rows_that_fit(int T, int Dh) {
  int rows = T;
  while (rows > 0 && smem_bytes<QT>(rows, Dh) > kMaxSmem) --rows;
  return rows;
}

// QT: q / out dtype. KVT: pool payload dtype (QT itself, or int8 when
// QUANT). Grid: (heads, slots, groups of `rows` query rows). Layouts: q,
// out [B, T_all, H, Dh] contiguous; k, v [N, bs, H, Dh]; k_scale, v_scale
// [N, bs, H]; table [B, E]; positions int64 rows of stride pos_stride
// (column 0 read).
template <typename QT, typename KVT, bool QUANT>
__global__ void __launch_bounds__(kThreads)
paged_general_kernel(const QT* __restrict__ q, const KVT* __restrict__ k,
                     const KVT* __restrict__ v,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ table,
                     const long long* __restrict__ positions,
                     long long pos_stride, QT* __restrict__ out, int T_all,
                     int rows, int H, int Dh, int E, int bs, float scale) {
  using C = Chain<QT>;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.z * rows;      // this group's first query row
  const int T = min(rows, T_all - t0);   // its rows
  const int tid = threadIdx.x;
  const int ld = Dh + 1;  // padded rows: no bank conflicts across keys
  // where bs <= 64, a tile of whole entries, up to 64 keys in all
  const int tile_entries = bs >= kTileKeys ? 1 : kTileKeys / bs;

  extern __shared__ double smem_raw[];
  C* acc = reinterpret_cast<C*>(smem_raw);  // [T][Dh]
  C* l_s = acc + T * Dh;                    // [T] normalizer
  float* q_s = reinterpret_cast<float*>(l_s + T);  // [T][ld]
  float* kv_s = q_s + T * ld;        // [64][ld] K of a tile, then V
  float* p_s = kv_s + kTileKeys * ld;  // [T][64] scores, then probs
  float* m_s = p_s + T * kTileKeys;  // [T] running max
  float* a_s = m_s + T;              // [T][tile_entries] per-entry rescale
  float* ks_s = a_s + T * kTileKeys;  // [64] K scales
  float* vs_s = ks_s + kTileKeys;     // [64] V scales
  float* pv_s = vs_s + kTileKeys;  // [T][Dh] P.V so far of a long entry
  float* sum_s = pv_s + T * Dh;    // [T][32] its lanes' partial sums
  float* mx_s = sum_s + T * 32;    // [T] its max

  // the group's rows are queries t0..t0+T-1 at positions base..base+T-1
  const long long base =
      positions[static_cast<size_t>(b) * pos_stride] + t0;
  const int* row = table + static_cast<size_t>(b) * E;
  const size_t row0 = static_cast<size_t>(b) * T_all + t0;
  for (int i = tid; i < T * Dh; i += kThreads) {
    const int t = i / Dh, d = i - t * Dh;
    q_s[t * ld + d] = to_float(q[((row0 + t) * H + h) * Dh + d]);
    acc[i] = C(0);
  }
  for (int t = tid; t < T; t += kThreads) {
    m_s[t] = kNegInf;
    l_s[t] = C(0);
  }
  long long reach = base + T - 1;
  if (reach < 0) reach = 0;
  const int last =
      static_cast<int>(min(reach / bs, static_cast<long long>(E - 1)));
  const int lane = tid & 31;
  __syncthreads();

  // keys j0..j0+n-1 of the tile of entries e0.. of pool `src` into kv_s
  // (key j is row j % bs of entry e0 + j / bs); their scales of
  // `src_scale` into `scale_s`
  const auto load_kv = [&](const KVT* __restrict__ src, int e0, int j0,
                           int n) {
    for (int i = tid; i < n * Dh; i += kThreads) {
      const int j = i / Dh, d = i - j * Dh;
      const size_t blk = static_cast<size_t>(row[e0 + (j0 + j) / bs]);
      kv_s[j * ld + d] =
          to_float(src[((blk * bs + (j0 + j) % bs) * H + h) * Dh + d]);
    }
  };
  const auto load_scales = [&](const float* __restrict__ src_scale,
                               float* scale_s, int e0, int j0, int n) {
    for (int j = tid; j < n; j += kThreads) {
      const size_t blk = static_cast<size_t>(row[e0 + (j0 + j) / bs]);
      scale_s[j] = src_scale[(blk * bs + (j0 + j) % bs) * H + h];
    }
  };
  // the masked scores of keys j0..j0+n-1 (K in kv_s) into p_s[t][j - j0]:
  // key position e0*bs + j against query base + t
  const auto score = [&](int e0, int j0, int n) {
    for (int i = tid; i < T * n; i += kThreads) {
      const int t = i / n, j = i - t * n;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d)
        s = fmaf(q_s[t * ld + d], kv_s[j * ld + d], s);
      s = __fmul_rn(s, scale);
      if (QUANT) s = __fmul_rn(s, ks_s[j]);
      p_s[t * kTileKeys + j] =
          (static_cast<long long>(e0) * bs + j0 + j <= base + t) ? s
                                                                 : kNegInf;
    }
  };

  if (bs <= kTileKeys) {
    for (int e0 = 0; e0 <= last; e0 += tile_entries) {
      const int n_entries = min(tile_entries, last - e0 + 1);
      const int keys = n_entries * bs;
      if (QUANT) {
        load_scales(k_scale, ks_s, e0, 0, keys);
        load_scales(v_scale, vs_s, e0, 0, keys);
      }
      load_kv(k, e0, 0, keys);
      __syncthreads();
      score(e0, 0, keys);
      __syncthreads();

      // V of the tile into the same buffer, while one warp per query row
      // steps the tile's entries as `_fused_body` steps them: probs
      // overwrite the scores, each entry's rescale factor goes to a_s
      load_kv(v, e0, 0, keys);
      for (int t = tid >> 5; t < T; t += kWarps) {
        float* p_row = p_s + t * kTileKeys;
        float m_prev = m_s[t];
        C l = l_s[t];
        for (int ei = 0; ei < n_entries; ++ei) {
          float* p_blk = p_row + ei * bs;
          float blk_max = kNegInf;
          for (int j = lane; j < bs; j += 32)
            blk_max = fmaxf(blk_max, p_blk[j]);
          for (int o = 16; o > 0; o >>= 1)
            blk_max =
                fmaxf(blk_max, __shfl_xor_sync(0xffffffffu, blk_max, o));
          const float m_new = fmaxf(m_prev, blk_max);
          const bool live = m_new > kNegInf * 0.5f;
          float sum = 0.f;
          for (int j = lane; j < bs; j += 32) {
            const float p = live ? expf(__fsub_rn(p_blk[j], m_new)) : 0.f;
            sum = __fadd_rn(sum, p);
            p_blk[j] =
                round_to<QT>(QUANT ? __fmul_rn(p, vs_s[ei * bs + j]) : p);
          }
          for (int o = 16; o > 0; o >>= 1)
            sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
          const float alpha = expf(__fsub_rn(m_prev, m_new));
          l = mul_add(l, C(alpha), C(sum));
          m_prev = m_new;
          if (lane == 0) a_s[t * tile_entries + ei] = alpha;
        }
        if (lane == 0) {
          m_s[t] = m_prev;
          l_s[t] = l;
        }
      }
      __syncthreads();

      // per entry P.V from zero, then acc
      for (int i = tid; i < T * Dh; i += kThreads) {
        const int t = i / Dh, d = i - t * Dh;
        const float* p_row = p_s + t * kTileKeys;
        const float* alpha = a_s + t * tile_entries;
        C a = acc[i];
        for (int ei = 0; ei < n_entries; ++ei) {
          float pv = 0.f;
          for (int j = ei * bs; j < (ei + 1) * bs; ++j)
            pv = fmaf(p_row[j], kv_s[j * ld + d], pv);
          a = mul_add(a, C(alpha[ei]), C(pv));
        }
        acc[i] = a;
      }
      __syncthreads();
    }
  } else {
    // one entry of bs > 64 keys, in two passes of 64-key chunks
    for (int e = 0; e <= last; ++e) {
      // pass 1: the entry's max
      for (int j0 = 0; j0 < bs; j0 += kTileKeys) {
        const int n = min(kTileKeys, bs - j0);
        if (QUANT) load_scales(k_scale, ks_s, e, j0, n);
        load_kv(k, e, j0, n);
        __syncthreads();
        score(e, j0, n);
        __syncthreads();
        for (int t = tid >> 5; t < T; t += kWarps) {
          const float* p_row = p_s + t * kTileKeys;
          float mx = kNegInf;
          for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_row[j]);
          for (int o = 16; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          if (lane == 0) mx_s[t] = j0 == 0 ? mx : fmaxf(mx_s[t], mx);
        }
      }
      // pass 2: the scores again, exp, the lanes' sums, P and its P.V
      for (int j0 = 0; j0 < bs; j0 += kTileKeys) {
        const int n = min(kTileKeys, bs - j0);
        __syncthreads();  // pass 1's maxima, the last P.V chunk, done
        if (QUANT) {
          load_scales(k_scale, ks_s, e, j0, n);
          load_scales(v_scale, vs_s, e, j0, n);
        }
        load_kv(k, e, j0, n);
        __syncthreads();
        score(e, j0, n);
        __syncthreads();
        for (int t = tid >> 5; t < T; t += kWarps) {
          float* p_row = p_s + t * kTileKeys;
          const float m_new = fmaxf(m_s[t], mx_s[t]);
          const bool live = m_new > kNegInf * 0.5f;
          float sum = j0 == 0 ? 0.f : sum_s[t * 32 + lane];
          for (int j = lane; j < n; j += 32) {
            const float p = live ? expf(__fsub_rn(p_row[j], m_new)) : 0.f;
            sum = __fadd_rn(sum, p);
            p_row[j] = round_to<QT>(QUANT ? __fmul_rn(p, vs_s[j]) : p);
          }
          sum_s[t * 32 + lane] = sum;
        }
        __syncthreads();
        load_kv(v, e, j0, n);
        __syncthreads();
        for (int i = tid; i < T * Dh; i += kThreads) {
          const int t = i / Dh, d = i - t * Dh;
          const float* p_row = p_s + t * kTileKeys;
          float pv = j0 == 0 ? 0.f : pv_s[i];
          for (int j = 0; j < n; ++j)
            pv = fmaf(p_row[j], kv_s[j * ld + d], pv);
          pv_s[i] = pv;
        }
      }
      __syncthreads();
      // close the entry: its sum, rescale, normalizer and running max
      for (int t = tid >> 5; t < T; t += kWarps) {
        float sum = sum_s[t * 32 + lane];
        for (int o = 16; o > 0; o >>= 1)
          sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
        const float m_prev = m_s[t];
        const float m_new = fmaxf(m_prev, mx_s[t]);
        const float alpha = expf(__fsub_rn(m_prev, m_new));
        __syncwarp();
        if (lane == 0) {
          l_s[t] = mul_add(l_s[t], C(alpha), C(sum));
          m_s[t] = m_new;
          a_s[t] = alpha;
        }
      }
      __syncthreads();
      for (int i = tid; i < T * Dh; i += kThreads)
        acc[i] = mul_add(acc[i], C(a_s[i / Dh]), C(pv_s[i]));
      __syncthreads();
    }
  }

  for (int i = tid; i < T * Dh; i += kThreads) {
    const int t = i / Dh, d = i - t * Dh;
    const C denom = l_s[t] > C(1e-30f) ? l_s[t] : C(1e-30f);
    out[((row0 + t) * H + h) * Dh + d] =
        from_float<QT>(static_cast<float>(acc[i] / denom));
  }
}

template <typename QT, typename KVT, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const int* table, const long long* positions,
                   long long pos_stride, void* out, int B, int T, int H,
                   int Dh, int E, int bs, float scale, cudaStream_t stream) {
  const int rows = rows_that_fit<QT>(T, Dh);
  if (rows < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<QT>(rows, Dh);
  auto kernel = paged_general_kernel<QT, KVT, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (T + rows - 1) / rows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), table, positions, pos_stride,
      static_cast<QT*>(out), T, rows, H, Dh, E, bs, scale);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 f32 pools, 1 bf16 pools, 2 int8 pools with f32 q, 3 int8
// pools with bf16 q. q and out are contiguous [B, T, H, Dh]; positions
// int64 rows of stride pos_stride. Returns a cudaError_t (0 = launched;
// cudaErrorInvalidValue also where one query row's block needs more
// shared memory than a block has: a head_dim past 849 in f32, 862 in
// bf16).
extern "C" int flashy_paged_general(int variant, const void* q, const void* k,
                                    const void* v, const void* k_scale,
                                    const void* v_scale, const int* table,
                                    const long long* positions,
                                    long long pos_stride, void* out, int B,
                                    int T, int H, int Dh, int E, int bs,
                                    float scale, void* stream) {
  if (B < 1 || T < 1 || T > kMaxQueries || H < 1 || Dh < 1 || E < 1 ||
      bs < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return launch<float, float, false>(q, k, v, k_scale, v_scale, table,
                                         positions, pos_stride, out, B, T, H,
                                         Dh, E, bs, scale, s);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16, false>(
          q, k, v, k_scale, v_scale, table, positions, pos_stride, out, B, T,
          H, Dh, E, bs, scale, s);
    case 2:
      return launch<float, int8_t, true>(q, k, v, k_scale, v_scale, table,
                                         positions, pos_stride, out, B, T, H,
                                         Dh, E, bs, scale, s);
    case 3:
      return launch<__nv_bfloat16, int8_t, true>(
          q, k, v, k_scale, v_scale, table, positions, pos_stride, out, B, T,
          H, Dh, E, bs, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
