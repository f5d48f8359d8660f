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
// bound, so the block products belong on the tensor cores. The T x T
// score matrix never reaches device memory, as the TPU kernels keep it in
// VMEM; the TPU grid's sequential innermost axis, carried in VMEM
// scratch, becomes a loop inside one thread block.
//
// The bf16 forward (`flash_fwd_kernel`) is Hopper-native: a persistent
// grid over the (b*h, 192 query rows) tiles, q-tiles heaviest (last)
// first; TMA loads Q once and K/V into a 4-stage ring of swizzled bf16
// tiles, three consumer warpgroups run Q K^T and P V as pipelined wgmma
// with the online softmax in registers (`hopper_forward`,
// flash_tile.cuh, which also says what bounds it and what is left). The f32 forward (`flash_fwd_f32_kernel`)
// and the backward kernels keep 64x64 f32 tiles in shared memory (padded
// rows), split over eight warps in the m16n8k16 fragment layout (a warp
// owns 16 rows and 32 columns): bf16 backward products as `mma.sync`
// with f32 accumulation on bf16-exact operands (Q, K, V and dO as
// loaded, P and dS after their rounding), f32 products as FMAs in
// ascending order; S, P and dS one f32 tile at a time in shared memory,
// the running statistics in shared memory and the accumulators in
// registers. The backward's wgmma/TMA redesign is later work. The f32
// forward's 64-key step (`forward_tile`) and the bf16 forward live in
// flash_tile.cuh, which the ring-attention kernel shares.
#include "flash_tile.cuh"

namespace {

struct Geometry {
  int B, H, Tq, Tk, offset;  // offset = Tk - Tq
  int causal;
  float scale;
};

// per-row f32 statistic [B*H, T] for rows row0..row0+63; `fill` past T
__device__ void load_stat(float* dst, const float* __restrict__ src, int bh,
                          int row0, int rows, float fill) {
  for (int r = threadIdx.x; r < kBlock; r += kThreads) {
    const int t = row0 + r;
    dst[r] = t < rows ? src[static_cast<size_t>(bh) * rows + t] : fill;
  }
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

// f32 forward: one block per (b*h, q-block); loops over the k-blocks up
// to the last causally visible one. Layouts: q, out [B, Tq, H, D]; k, v
// [B, Tk, H, D]; lse [B, H, Tq] f32.
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, Geometry g) {
  const int bh = blockIdx.x, qi = blockIdx.y;
  const int b = bh / g.H, h = bh - b * g.H;
  const int q0 = qi * kBlock;

  extern __shared__ float smem[];
  const ForwardSmem s = forward_smem(smem);
  float acc[4][4];
  forward_begin(s, q, b, h, q0, g.Tq, g.H, acc);
  const int last = last_kblock(qi, g);
  for (int ki = 0; ki <= last; ++ki) {
    const int k0 = ki * kBlock;
    forward_tile<float>(
        s, k, v, b, h, k0, g.Tk, g.H, g.scale,
        [&](int r, int c) { return visible(q0 + r, k0 + c, g); }, acc);
  }
  forward_end(s, out, lse, b, h, q0, g.Tq, g.H, acc);
}

// bf16 forward on Hopper: a persistent grid over the (b*h, 192 query
// rows) tiles (`hopper::hopper_forward`). The same layouts, through
// tensor maps of q, k and v.
__global__ void __launch_bounds__(hopper::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 const Geometry g) {
  extern __shared__ unsigned char hopper_smem[];
  const hopper::Segment seg{&k_map, &v_map, g.Tk, g.offset, g.causal};
  hopper::hopper_forward(
      hopper_smem, &q_map, 1, [seg](int) { return seg; }, out, lse,
      g.B * g.H, g.H, g.Tq, g.scale);
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

constexpr size_t kBwdSmem = (6 * kTile + 2 * kBlock) * sizeof(float);

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

cudaError_t forward_f32(const void* q, const void* k, const void* v,
                        void* out, float* lse, const Geometry& g,
                        cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_fwd_f32_kernel, kFwdSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(g.B * g.H, (g.Tq + kBlock - 1) / kBlock);
  flash_fwd_f32_kernel<<<grid, kThreads, kFwdSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, g);
  return cudaGetLastError();
}

// a cudaError_t, or hopper::kTensorMapError + a CUresult
int forward_bf16(const void* q, const void* k, const void* v, void* out,
                 float* lse, const Geometry& g, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = hopper::encode_rows(&q_map, q, g.B, g.Tq, g.H);
  if (err == 0) err = hopper::encode_rows(&k_map, k, g.B, g.Tk, g.H);
  if (err == 0) err = hopper::encode_rows(&v_map, v, g.B, g.Tk, g.H);
  if (err != 0) return err;
  err = allow_smem(flash_fwd_kernel, hopper::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int blocks =
      hopper::persistent_blocks(g.B * g.H * hopper::q_tiles(g.Tq));
  flash_fwd_kernel<<<blocks, hopper::kThreads, hopper::kSmemBytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, g);
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
         static_cast<long long>(B) * H * hopper::q_tiles(Tq) <=
             0x7fffffffLL &&
         (Tq + kBlock - 1) / kBlock <= 65535 &&
         (Tk + kBlock - 1) / kBlock <= 65535;
}

}  // namespace

// dtype: 0 f32, 1 bf16. Returns a cudaError_t (0 = launched), or for a
// refused tensor map hopper::kTensorMapError + its CUresult.
extern "C" int flashy_flash_forward(int dtype, const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    int B, int H, int Tq, int Tk, int D,
                                    int causal, float scale, void* stream) {
  if (!valid(dtype, B, H, Tq, Tk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{B, H, Tq, Tk, Tk - Tq, causal ? 1 : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? static_cast<int>(forward_f32(q, k, v, out, lse, g, s))
                    : forward_bf16(q, k, v, out, lse, g, s);
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
