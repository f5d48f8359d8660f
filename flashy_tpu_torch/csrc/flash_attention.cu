// Flash attention, forward and backward, on Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of flashy_tpu/ops/attention.py:
//   * flash_fwd_kernel                   <- `_flash_kernel` (launched by
//     `_flash_forward`): blockwise online softmax, out + per-row
//     logsumexp;
//   * flash_bwd_hopper_kernel<kBwdDq>    <- `_flash_dq_kernel` (split
//     backward, `_flash_backward`): dQ with the k-blocks innermost;
//   * flash_bwd_hopper_kernel<kBwdDkv>   <- `_flash_dkv_kernel` (split
//     backward): dK, dV with the q-blocks innermost;
//   * flash_bwd_hopper_kernel<kBwdFused> <- `_flash_bwd_fused_kernel`
//     (`_flash_backward_fused`): dK, dV as the split kernel, and dQ
//     folded in the kernel, in k order, into bf16 dQ.
// In f32 the three backward kernels are `flash_bwd_dq_f32_kernel` and
// `flash_bwd_kv_f32_kernel<FUSED>`, the last writing one f32 dQ partial
// per (k-block, q-block) pair to a [nk, B, Tq, H, D] buffer that the
// caller folds in k order, as the TPU kernel does.
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
// Fused and split backward are bit-identical in both dtypes: every
// (q-block, k-block) pair computes S, P, dP, dS and the dQ block product
// dS.K with the same device code and the same instruction sequence, the
// block product starts from zero, and dQ adds whole block products in k
// order with non-contracted adds (__fadd_rn): the split dQ kernel in its
// registers, the bf16 fused kernel through the ordered chain below, the
// f32 caller's left fold over the partials. No atomics.
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
// flash_tile.cuh, which also says what bounds it and what is left).
//
// The bf16 backward (`flash_bwd_hopper_kernel`, one template for the
// three kernels) has the same skeleton: a persistent grid, one block an
// SM, of two consumer warpgroups and a producer warp. A work tile is two
// adjacent 64-row blocks of one (b, h), one per consumer warpgroup, held
// resident in shared memory, while the producer streams the other side's
// 64-row blocks past both through a TMA ring (`kBwdStages` stages of two
// swizzled bf16 tiles; mbarrier full/empty pairs): for dK/dV and the
// fused kernel K and V are resident and the q-blocks' Q, dO, lse and D
// stream; for dQ Q, dO, lse and D are resident and K/V stream. The
// producer loads the next tile's resident blocks into a second buffer
// while the consumers finish the current tile. Every pair runs one step,
// `hopper::backward_pair` (flash_tile.cuh): S^T = K Q^T and dP^T = V dO^T
// as wgmma with the keys as M (FA3's orientation), P^T and dS^T in
// registers, then dV += P^T dO and dK += dS^T Q as wgmma with P^T and
// dS^T as register A operands (in place: fused and split run this same
// code), and the dQ block product dS K from zero with dS^T staged once in
// swizzled shared memory. The causal skip and the ragged edges are
// warp-uniform, so no wgmma sits behind a branch that ptxas cannot prove
// uniform (it would serialize every one, info C7520).
//
// dQ in the fused kernel. The k-blocks of a q-block are held by different
// warpgroups and blocks of the grid, and dQ must be their block products
// added in k order from zero, dq = ((0 + p0) + p1) + ..., the additions
// of the split kernel (non-contracted __fadd_rn, no atomics). A block's
// first warpgroup (k-block 2 rt) waits (acquire) until the q-block's
// counter reads 2 rt, loads the f32 sum that k-block 2 rt - 1 stored in
// the accumulator [B*H, nq*64, 64], adds its product and hands the sum
// to the block's second warpgroup (k-block 2 rt + 1) through shared
// memory; the second adds its product, stores the sum and publishes the
// count 2 rt + 2 (release) at its next pair, for the next tile's first
// warpgroup in another block. The last k-block that a q-block sees writes
// bf16 dQ instead, and k-block 0 writes zeros for q-blocks that see no
// key. The wrapper allocates the accumulator and zeroes the counters.
// Why no wait can hang: the grid has at most one block an SM, so all its
// blocks are resident at once, and a block walks its tiles in ascending
// order (heads fastest, k-blocks ascending). Order the (tile, warpgroup)
// units so: every wait is on an earlier unit (the second warpgroup on
// the first of its tile, the first on the previous tile's second, whose
// block is another), and a deferred publication waits only on the
// producer, which waits only on the block's own consumers releasing
// earlier blocks of the stream. The earliest unfinished unit therefore
// waits on nothing unfinished and completes; by induction all do. A wait
// that never ends is a bug and traps after ~10 s (`wait_count`,
// `mbar_wait`). With heads fastest, k-block ki - 1 of a head starts
// ~B*H/132 tiles before k-block ki and sees its q-blocks in the same
// order, so the chain rarely waits at the training shapes.
//
// The f32 forward (`flash_fwd_f32_kernel`) and the f32 backward keep 64x64
// f32 tiles in shared memory (padded rows), split over eight warps in the
// m16n8k16 fragment layout (a warp owns 16 rows and 32 columns), products
// as FMAs in ascending order; S, P and dS one f32 tile at a time in
// shared memory, the running statistics in shared memory and the
// accumulators in registers. The f32 forward's 64-key step
// (`forward_tile`) and the bf16 steps live in flash_tile.cuh, which the
// ring-attention kernel shares.
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

// the first q-block that k-block ki is visible to (`block_visible`)
__device__ __forceinline__ int first_qblock(int ki, const Geometry& g) {
  if (!g.causal) return 0;
  const int need = ki * kBlock - (kBlock - 1) - g.offset;
  return need <= 0 ? 0 : (need + kBlock - 1) / kBlock;
}

// ---- f32 ----------------------------------------------------------------

// The f32 backward's per-pair block: S recomputed, P = guarded exp(S -
// lse) into p_s, dP = dO V^T, dS = P (dP - D) scale into ds_s. Shared by
// the three f32 backward kernels.
__device__ void probs_and_ds(const float* q_s, const float* k_s,
                             const float* v_s, const float* do_s,
                             const float* lse_s, const float* delta_s,
                             float* p_s, float* ds_s, int q0, int k0,
                             const Geometry& g) {
  float s[4][4], dp[4][4];
  product_abt(q_s, k_s, s);
  product_abt(do_s, v_s, dp);
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
      p_s[r * kLd + c] = p;
      ds_s[r * kLd + c] =
          __fmul_rn(__fmul_rn(p, __fsub_rn(dp[j][e], delta_s[r])), g.scale);
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
    forward_tile(
        s, k, v, b, h, k0, g.Tk, g.H, g.scale,
        [&](int r, int c) { return visible(q0 + r, k0 + c, g); }, acc);
  }
  forward_end(s, out, lse, b, h, q0, g.Tq, g.H, acc);
}

// f32 split backward dQ: one block per (b*h, q-block), k-blocks
// innermost; dQ += dS.K one whole block product at a time, in k order.
// lse and delta are [B, H, Tq] f32; dq is [B, Tq, H, D].
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, Geometry g) {
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
    probs_and_ds(q_s, k_s, v_s, do_s, lse_s, delta_s, p_s, ds_s, q0, k0, g);
    __syncthreads();
    float blk[4][4];
    product_ab(ds_s, k_s, blk);
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
      if (t < g.Tq) dq[row_at(b, t, h, g.Tq, g.H) + tile_col(j, e)] = acc[j][e];
    }
}

// f32 backward dK/dV (split, FUSED = false) or the one-pass backward
// (FUSED = true): one block per (b*h, k-block), q-blocks innermost. dV +=
// P^T.dO and dK += dS^T.Q one whole block product at a time, in q order.
// The fused kernel also writes each pair's dS.K to dqp [nk, B, Tq, H, D],
// and exact zeros for the pairs that causality skips.
template <bool FUSED>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_kv_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ dqp, Geometry g) {
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
    probs_and_ds(q_s, k_s, v_s, do_s, lse_s, delta_s, p_s, ds_s, q0, k0, g);
    __syncthreads();
    float blk[4][4];
    product_atb(p_s, do_s, blk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dv_acc[j][e] = __fadd_rn(dv_acc[j][e], blk[j][e]);
    product_atb(ds_s, q_s, blk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dk_acc[j][e] = __fadd_rn(dk_acc[j][e], blk[j][e]);
    if (FUSED) {
      product_ab(ds_s, k_s, blk);
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
        dk[at] = dk_acc[j][e];
        dv[at] = dv_acc[j][e];
      }
    }
}

// ---- bf16 ---------------------------------------------------------------

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

// The three bf16 backward kernels (MODE): the split dQ kernel, the split
// dK/dV kernel, the one-pass kernel.
enum BwdMode { kBwdDq = 0, kBwdDkv = 1, kBwdFused = 2 };

// Compile-time choices of the bf16 backward, measured on the H100 at the
// training shapes (root PERF.md, Findings): three stages beat two by 5-9% on
// the split kernels (two were 2% faster on the fused one) and four, with
// more shared memory, were 11% slower on the fused kernel.
constexpr int kBwdConsumers = 2;  // consumer warpgroups: resident blocks
constexpr int kBwdStages = 3;     // streamed blocks in flight
constexpr int kBwdThreads = 128 * kBwdConsumers + 128;  // + the producer's
// at launch 65536 / 384 -> 168 a thread; setmaxnreg moves them
constexpr int kBwdProducerRegs = 24, kBwdConsumerRegs = 240;
static_assert(kBwdProducerRegs * 128 + kBwdConsumerRegs * 128 *
                  kBwdConsumers <= 65536,
              "the warpgroups' registers must fit one SM");
static_assert(kBwdConsumers == 2,
              "the fused dQ fold hands each sum from the first consumer "
              "warpgroup to the second");

// Every tile 1024-byte aligned (the 128-byte swizzle's period). A `stat`
// slot holds a q-block's lse (NEG_INF past Tq) then its D (0 past Tq).
struct alignas(1024) BwdSmem {
  // resident blocks of each consumer warpgroup, two work tiles deep:
  // K, V (dK/dV, fused) or Q, dO (dQ)
  __nv_bfloat16 res[2][kBwdConsumers][2][kBlock * kDim];
  // streamed blocks: Q, dO (dK/dV, fused) or K, V (dQ)
  __nv_bfloat16 str[kBwdStages][2][kBlock * kDim];
  __nv_bfloat16 ds[kBwdConsumers][kBlock * kDim];  // dS^T for dS K
  float hand[kBwdStages][kBlock * kDim];  // fused: dQ sums handed on
  float res_stat[2][kBwdConsumers][2 * kBlock];      // dQ
  float str_stat[kBwdStages][2 * kBlock];            // dK/dV, fused
  uint64_t res_full[2], res_empty[2];
  uint64_t full[kBwdStages], empty[kBwdStages], hand_full[kBwdStages];
};
constexpr size_t kBwdSmemBytes = sizeof(BwdSmem) + 1024;  // + alignment
static_assert(sizeof(BwdSmem) > 232448 / 2,
              "one block an SM: the ordered dQ chain needs every block of "
              "the grid resident at once");

// lse and D of q-block rows row0..row0+63 of head bh into a stat slot, by
// the 32 lanes of the producer warp
__device__ __forceinline__ void load_stats(float* slot,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int bh, int row0, int Tq,
                                           int lane) {
#pragma unroll
  for (int r = lane; r < kBlock; r += 32) {
    const int t = row0 + r;
    const size_t at = static_cast<size_t>(bh) * Tq + t;
    slot[r] = t < Tq ? lse[at] : kNegInf;
    slot[kBlock + r] = t < Tq ? delta[at] : 0.f;
  }
}

// The bf16 backward of [B, T, H, 64] tensors (tensor maps of q, k, v and
// dO; lse, delta [B*H, Tq] f32): dq (kBwdDq), dk and dv (kBwdDkv), or all
// three (kBwdFused, with the f32 accumulator dq_acc [B*H, nq*64, 64] and
// the zeroed counters dq_count [B*H*nq]). A persistent grid: block j
// takes work tiles j, j + gridDim.x, ...; the producer warp loads each
// tile's resident blocks and streams the other side's blocks, the two
// consumer warpgroups run `hopper::backward_pair` on every visible pair.
template <int MODE>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_hopper_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv,
                        float* __restrict__ dq_acc,
                        unsigned* __restrict__ dq_count, const Geometry g) {
  using namespace hopper;
  // q-blocks stream past resident k-blocks (dK/dV, fused), or the reverse
  constexpr bool kQStream = MODE != kBwdDq;
  extern __shared__ unsigned char hopper_smem[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(
      (reinterpret_cast<uintptr_t>(hopper_smem) + 1023) & ~uintptr_t{1023});
  // the warpgroup, broadcast so that every branch on it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int heads = g.B * g.H;
  const int nq = (g.Tq + kBlock - 1) / kBlock;
  const int nk = (g.Tk + kBlock - 1) / kBlock;
  const int n_res = kQStream ? nk : nq;  // resident blocks a head
  const int per_head = (n_res + kBwdConsumers - 1) / kBwdConsumers;
  const int n_tiles = heads * per_head;
  // tile i: head i % heads; its blocks kBwdConsumers * rt.. for rt = i /
  // heads ascending (k-blocks: the dQ chain's order) or, for dQ,
  // descending (the causally heaviest q-blocks first)
  const auto tile_at = [&](int i, int& bh, int& rt) {
    bh = i % heads;
    rt = kQStream ? i / heads : per_head - 1 - i / heads;
  };
  // the streamed blocks a tile visits: those some resident block sees
  const auto stream_range = [&](int rt, int& first, int& last) {
    const int lo = rt * kBwdConsumers;
    if (kQStream) {
      first = first_qblock(lo, g);
      last = nq - 1;
    } else {
      first = 0;
      last = last_kblock(min(lo + kBwdConsumers - 1, nq - 1), g);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.res_full[i], 33);  // expect_tx + the 32 producer lanes
      mbar_init(&s.res_empty[i], 128 * kBwdConsumers);
    }
    for (int i = 0; i < kBwdStages; ++i) {
      mbar_init(&s.full[i], 33);
      mbar_init(&s.empty[i], 128 * kBwdConsumers);
      mbar_init(&s.hand_full[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kBwdConsumers) {
    // producer: one warp; lane 0 starts the TMA loads, every lane loads
    // its share of lse and D and arrives on the stage's full barrier
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kBwdProducerRegs));
    if (threadIdx.x >= 128 * kBwdConsumers + 32) return;
    const int lane = threadIdx.x & 31;
    int it = 0, round = 0;
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x, ++round) {
      int bh, rt, first, last;
      tile_at(i, bh, rt);
      stream_range(rt, first, last);
      const int b = bh / g.H, h = bh % g.H;
      const int buf = round & 1;
      const int held = min(kBwdConsumers, n_res - rt * kBwdConsumers);
      mbar_wait(&s.res_empty[buf], ((round >> 1) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&s.res_full[buf], held * 2 * kTileBytes);
        for (int w = 0; w < held; ++w) {
          const int row = (rt * kBwdConsumers + w) * kBlock;
          tma_load(s.res[buf][w][0], kQStream ? &k_map : &q_map,
                   &s.res_full[buf], h, row, b);
          tma_load(s.res[buf][w][1], kQStream ? &v_map : &do_map,
                   &s.res_full[buf], h, row, b);
        }
      }
      if (!kQStream)
        for (int w = 0; w < held; ++w)
          load_stats(s.res_stat[buf][w], lse, delta, bh,
                     (rt * kBwdConsumers + w) * kBlock, g.Tq, lane);
      mbar_arrive(&s.res_full[buf]);
      for (int j = first; j <= last; ++j, ++it) {
        const int st = it % kBwdStages;
        mbar_wait(&s.empty[st], ((it / kBwdStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&s.full[st], 2 * kTileBytes);
          tma_load(s.str[st][0], kQStream ? &q_map : &k_map, &s.full[st], h,
                   j * kBlock, b);
          tma_load(s.str[st][1], kQStream ? &do_map : &v_map, &s.full[st],
                   h, j * kBlock, b);
        }
        if (kQStream)
          load_stats(s.str_stat[st], lse, delta, bh, j * kBlock, g.Tq, lane);
        mbar_arrive(&s.full[st]);
      }
    }
    return;
  }

  // consumer warpgroup wg: resident block rt * kBwdConsumers + wg
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kBwdConsumerRegs));
  const int t = threadIdx.x & 127, lane = t & 31;
  // this thread's rows r0, r0 + 8 and columns c0, c0 + 1 of each 8-column
  // block of a 64x64 accumulator (element i: row r0 + 8 ((i >> 1) & 1),
  // column 8 (i >> 2) + c0 + (i & 1))
  const int r0 = 16 * (t >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
  const BwdMask mask{g.Tk, g.offset, g.causal};
  const uint64_t ds_desc = tile_desc(s.ds[wg]);
  int it = 0, round = 0;
  for (int i = blockIdx.x; i < n_tiles; i += gridDim.x, ++round) {
    int bh, rt, first, last;
    tile_at(i, bh, rt);
    stream_range(rt, first, last);
    const int b = bh / g.H, h = bh % g.H;
    const int buf = round & 1;
    const int mine = rt * kBwdConsumers + wg;  // -> n_res: no block
    // the streamed blocks this warpgroup's block sees: [lo, hi]
    int lo = 1, hi = 0;
    if (mine < n_res) {
      lo = kQStream ? first_qblock(mine, g) : 0;
      hi = kQStream ? nq - 1 : last_kblock(mine, g);
    }
    const __nv_bfloat16* res0 = s.res[buf][wg][0];
    const __nv_bfloat16* res1 = s.res[buf][wg][1];
    // dV and dK (dK/dV, fused), or dQ (dQ: acc_a only)
    float acc_a[32], acc_b[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc_a[e] = acc_b[e] = 0.f;

    // The fused kernel's dQ fold. The first warpgroup (k-block 2 rt)
    // acquires k-block 2 rt - 1's sum of the q-block and loads it while its
    // S^T and dP^T run (`meanwhile`), adds its block product, and hands
    // the sum to the second warpgroup (k-block 2 rt + 1) through shared
    // memory (`hand`, each thread its own 32 values; `hand_full`, one
    // phase a streamed block), or writes bf16 dQ where it is the
    // q-block's last k-block. The second adds its own and stores the sum
    // for the next tile's first warpgroup, or writes bf16 dQ; it
    // publishes the count at its next pair or at the end of the tile, as
    // the waiter is another block's later tile.
    float prev[32];
    unsigned* release = nullptr;  // a count to publish, and its value
    unsigned release_value = 0;
    const auto publish = [&] {
      if (release == nullptr) return;
      warpgroup_sync(wg);  // every thread's stores before the release
      publish_count(release, release_value, t == 0);
      release = nullptr;
    };
    mbar_wait(&s.res_full[buf], (round >> 1) & 1);

    for (int j = first; j <= last; ++j, ++it) {
      const int st = it % kBwdStages;
      mbar_wait(&s.full[st], (it / kBwdStages) & 1);
      if (j < lo || j > hi) {  // a block only the other warpgroup sees
        mbar_arrive(&s.empty[st]);
        continue;
      }
      const int k0 = (kQStream ? mine : j) * kBlock;
      const int q0 = (kQStream ? j : mine) * kBlock;
      const uint64_t k_desc = tile_desc(kQStream ? res0 : s.str[st][0]);
      const uint64_t v_desc = tile_desc(kQStream ? res1 : s.str[st][1]);
      const uint64_t q_desc = tile_desc(kQStream ? s.str[st][0] : res0);
      const uint64_t do_desc = tile_desc(kQStream ? s.str[st][1] : res1);
      const float* stats = kQStream ? s.str_stat[st] : s.res_stat[buf][wg];
      const size_t pair = static_cast<size_t>(bh) * nq + j;
      const auto meanwhile = [&] {
        if (MODE != kBwdFused) return;
        publish();
        if (wg != 0) return;
#pragma unroll
        for (int e = 0; e < 32; ++e) prev[e] = 0.f;
        if (mine == 0) return;
        const float* sum = dq_acc + pair * (kBlock * kDim);
        wait_count(dq_count + pair, mine);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const float2 x = __ldcg(reinterpret_cast<const float2*>(
              sum + (r0 + 8 * (jj & 1)) * kDim + 8 * (jj >> 1) + c0));
          prev[2 * jj] = x.x;
          prev[2 * jj + 1] = x.y;
        }
      };
      uint32_t p[16], ds[16];
      constexpr bool kStage = MODE != kBwdDkv;
      if (k0 + kBlock > g.Tk || (g.causal && q0 + g.offset < k0 + kBlock - 1))
        backward_pair<true, kStage>(k_desc, v_desc, q_desc, do_desc, stats,
                                    s.ds[wg], wg, k0, q0, mask, g.scale, p,
                                    ds, meanwhile);
      else
        backward_pair<false, kStage>(k_desc, v_desc, q_desc, do_desc,
                                     stats, s.ds[wg], wg, k0, q0, mask,
                                     g.scale, p, ds, meanwhile);
      float blk[32];
      wgmma_fence();
      if (MODE != kBwdDq) start_dkv(acc_a, acc_b, p, ds, do_desc, q_desc);
      if (MODE != kBwdDkv) start_dq(blk, ds_desc, k_desc);
      wgmma_commit();
      wgmma_wait<0>();
      hold(acc_a);
      hold(acc_b);
      if (MODE != kBwdDkv) hold(blk);
      if (MODE == kBwdDq) {
#pragma unroll
        for (int e = 0; e < 32; ++e) acc_a[e] = __fadd_rn(acc_a[e], blk[e]);
      }
      if (MODE == kBwdFused) {
        float* hand = s.hand[st];
        if (wg != 0) {
          mbar_wait(&s.hand_full[st], (it / kBwdStages) & 1);
#pragma unroll
          for (int e = 0; e < 32; ++e) prev[e] = hand[e * 128 + t];
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) prev[e] = __fadd_rn(prev[e], blk[e]);
        if (mine == last_kblock(j, g)) {
          // the q-block's last k-block: dQ in bf16
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = q0 + r0 + 8 * r;
            if (row >= g.Tq) continue;
            __nv_bfloat16* dst = dq + row_at(b, row, h, g.Tq, g.H) + c0;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) =
                  __floats2bfloat162_rn(prev[4 * jj + 2 * r],
                                        prev[4 * jj + 2 * r + 1]);
          }
        } else if (wg == 0) {
#pragma unroll
          for (int e = 0; e < 32; ++e) hand[e * 128 + t] = prev[e];
        } else {
          float* sum = dq_acc + pair * (kBlock * kDim);
#pragma unroll
          for (int jj = 0; jj < 16; ++jj)
            __stcg(reinterpret_cast<float2*>(sum + (r0 + 8 * (jj & 1)) * kDim +
                                             8 * (jj >> 1) + c0),
                   make_float2(prev[2 * jj], prev[2 * jj + 1]));
          release = dq_count + pair;
          release_value = mine + 1;
        }
        // one phase a streamed block, handed or not (the first warpgroup
        // sees every block of the stream)
        if (wg == 0) mbar_arrive(&s.hand_full[st]);
      }
      mbar_arrive(&s.empty[st]);
    }
    if (MODE == kBwdFused) publish();

    if (mine < n_res) {
      // the resident block's gradients in bf16, rows past T not written
      const int T = kQStream ? g.Tk : g.Tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = mine * kBlock + r0 + 8 * r;
        if (row >= T) continue;
        const size_t at = row_at(b, row, h, T, g.H) + c0;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int e = 4 * jj + 2 * r;
          if (kQStream) {
            *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * jj) =
                __floats2bfloat162_rn(acc_b[e], acc_b[e + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * jj) =
                __floats2bfloat162_rn(acc_a[e], acc_a[e + 1]);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dq + at + 8 * jj) =
                __floats2bfloat162_rn(acc_a[e], acc_a[e + 1]);
          }
        }
      }
      // fused: k-block 0 writes zero dQ for the q-blocks that see no key
      if (MODE == kBwdFused && mine == 0) {
        const int empty_rows = min(first_qblock(0, g) * kBlock, g.Tq);
        for (int row = t; row < empty_rows; row += 128)
          for (int c = 0; c < kDim; c += 8)
            *reinterpret_cast<uint4*>(dq + row_at(b, row, h, g.Tq, g.H) + c) =
                make_uint4(0u, 0u, 0u, 0u);
      }
    }
    mbar_arrive(&s.res_empty[buf]);
  }
}

// ---- host ---------------------------------------------------------------

constexpr size_t kBwdSmemF32 = (6 * kTile + 2 * kBlock) * sizeof(float);

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

cudaError_t backward_f32(int kind, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* delta, void* dq, void* dk, void* dv,
                         float* dqp, const Geometry& g, cudaStream_t stream) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  cudaError_t err;
  if (kind == kBwdDq) {
    auto kernel = flash_bwd_dq_f32_kernel;
    if ((err = allow_smem(kernel, kBwdSmemF32)) != cudaSuccess) return err;
    dim3 grid(g.B * g.H, (g.Tq + kBlock - 1) / kBlock);
    kernel<<<grid, kThreads, kBwdSmemF32, stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<float*>(dq), g);
  } else {
    auto kernel = kind == kBwdDkv ? flash_bwd_kv_f32_kernel<false>
                                  : flash_bwd_kv_f32_kernel<true>;
    if ((err = allow_smem(kernel, kBwdSmemF32)) != cudaSuccess) return err;
    dim3 grid(g.B * g.H, (g.Tk + kBlock - 1) / kBlock);
    kernel<<<grid, kThreads, kBwdSmemF32, stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), dqp, g);
  }
  return cudaGetLastError();
}

// a cudaError_t, or hopper::kTensorMapError + a CUresult
template <int MODE>
int backward_bf16(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, void* dk, void* dv, float* dq_acc,
                  unsigned* dq_count, const Geometry& g,
                  cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  int err = hopper::encode_rows(&q_map, q, g.B, g.Tq, g.H);
  if (err == 0) err = hopper::encode_rows(&k_map, k, g.B, g.Tk, g.H);
  if (err == 0) err = hopper::encode_rows(&v_map, v, g.B, g.Tk, g.H);
  if (err == 0) err = hopper::encode_rows(&do_map, dout, g.B, g.Tq, g.H);
  if (err != 0) return err;
  auto kernel = flash_bwd_hopper_kernel<MODE>;
  if ((err = allow_smem(kernel, kBwdSmemBytes)) != cudaSuccess) return err;
  const int n_res = ((MODE == kBwdDq ? g.Tq : g.Tk) + kBlock - 1) / kBlock;
  const int blocks = hopper::persistent_blocks(
      g.B * g.H * ((n_res + kBwdConsumers - 1) / kBwdConsumers));
  using bf16 = __nv_bfloat16;
  kernel<<<blocks, kBwdThreads, kBwdSmemBytes, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), dq_acc, dq_count, g);
  return cudaGetLastError();
}

bool valid(int dtype, int B, int H, int Tq, int Tk, int D) {
  return (dtype == 0 || dtype == 1) && B >= 1 && H >= 1 && Tq >= 1 &&
         Tk >= 1 && D == kDim &&
         static_cast<long long>(B) * H * hopper::q_tiles(Tq) <=
             0x7fffffffLL &&
         static_cast<long long>(B) * H * ((Tq + kBlock - 1) / kBlock) <=
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

// kind: 0 split dQ (writes dq), 1 split dK/dV (dk, dv), 2 fused. The
// fused kernel writes dk and dv and, in f32, the dQ partials [nk, B, Tq,
// H, D] to `scratch` (the caller folds them); in bf16 it writes dq, with
// `scratch` its f32 accumulator [B*H, nq*64, 64] and `counts` [B*H*nq]
// zeroed. Returns a cudaError_t (0 = launched), or for a refused tensor
// map hopper::kTensorMapError + its CUresult.
extern "C" int flashy_flash_backward(int kind, int dtype, const void* q,
                                     const void* k, const void* v,
                                     const void* dout, const float* lse,
                                     const float* delta, void* dq, void* dk,
                                     void* dv, float* scratch,
                                     unsigned* counts, int B, int H, int Tq,
                                     int Tk, int D, int causal, float scale,
                                     void* stream) {
  if (kind < 0 || kind > 2 || !valid(dtype, B, H, Tq, Tk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{B, H, Tq, Tk, Tk - Tq, causal ? 1 : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(backward_f32(kind, q, k, v, dout, lse, delta, dq,
                                         dk, dv, scratch, g, s));
  const auto run = kind == kBwdDq    ? &backward_bf16<kBwdDq>
                   : kind == kBwdDkv ? &backward_bf16<kBwdDkv>
                                     : &backward_bf16<kBwdFused>;
  return run(q, k, v, dout, lse, delta, dq, dk, dv, scratch, counts, g, s);
}
