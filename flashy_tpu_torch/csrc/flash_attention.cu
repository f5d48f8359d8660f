// Flash attention in bf16, forward and backward, on Hopper (sm_90a), at
// head_dim 64 and 128.
//
// Replaces the four Pallas TPU kernels of flashy_tpu/ops/attention.py:
//   * flash_fwd_kernel<DIM>                   <- `_flash_kernel` (launched
//     by `_flash_forward`): blockwise online softmax, out + per-row
//     logsumexp;
//   * flash_bwd_hopper_kernel<DIM, kBwdDq>    <- `_flash_dq_kernel` (split
//     backward, `_flash_backward`): dQ with the k-blocks innermost;
//   * flash_bwd_hopper_kernel<DIM, kBwdDkv>   <- `_flash_dkv_kernel` (split
//     backward): dK, dV with the q-blocks innermost;
//   * flash_bwd_hopper_kernel<DIM, kBwdFused> <- `_flash_bwd_fused_kernel`
//     (`_flash_backward_fused`): dK, dV as the split kernel, and dQ
//     folded in the kernel, in k order, into bf16 dQ.
// f32 inputs, and bf16 at the other head dims, take the same four kernels
// of flash_general.cu (`ops/attention.py` `flash_route`).
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
//   * rounding points: P is rounded to bf16 before P.V and before P^T.dO;
//     dS = P * (dP - D) * scale is rounded to bf16 for dS.K and dS^T.Q.
//     Products and sums are f32.
//   * the online softmax steps once per 64-key tile, so bf16 results
//     depend on the tile; the plain version in ops/attention.py steps at
//     the same tile.
//
// Fused and split backward are bit-identical: every (q-block, k-block)
// pair computes S, P, dP, dS and the dQ block product dS.K with the same
// device code and the same instruction sequence, the block product starts
// from zero, and dQ adds whole block products in k order with
// non-contracted adds (__fadd_rn): the split dQ kernel in its registers,
// the fused kernel through the ordered chain below. No atomics.
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
// The forward (`flash_fwd_kernel<DIM>`) is a persistent grid over the
// (b*h, 192 query rows at 64, 128 at 128) tiles, q-tiles heaviest (last)
// first; TMA loads Q once and K/V into a 4-stage ring of swizzled bf16
// tiles, the consumer warpgroups run Q K^T and P V as pipelined wgmma with
// the online softmax in registers (`hopper_forward`, flash_tile.cuh, which
// also says what bounds it and what is left).
//
// The backward (`flash_bwd_hopper_kernel`, one template for the three
// kernels) has the same skeleton: a persistent grid, one block an SM, of
// two consumer warpgroups and a producer warp. A work tile is two
// adjacent 64-row blocks of one (b, h), one per consumer warpgroup, held
// resident in shared memory, while the producer streams the other side's
// 64-row blocks past both through a TMA ring (`Bwd::kStages` stages of two
// swizzled bf16 tiles; mbarrier full/empty pairs): for dK/dV and the
// fused kernel K and V are resident and the q-blocks' Q, dO, lse and D
// stream; for dQ Q, dO, lse and D are resident and K/V stream. At 64 the
// producer loads the next tile's resident blocks into a second buffer
// while the consumers finish the current tile; at 128 there is one
// (`Bwd::kResBufs`), as the 64x128 tiles fill shared memory. Every pair
// runs one step, `hopper::backward_pair` (flash_tile.cuh): S^T = K Q^T and
// dP^T = V dO^T as wgmma with the keys as M (FA3's orientation), P^T and
// dS^T in registers, then dV += P^T dO and dK += dS^T Q as wgmma with P^T
// and dS^T as register A operands (in place: fused and split run this
// same code), and the dQ block product dS K from zero with dS^T staged
// once in swizzled shared memory, one 64-column box at a time. The causal
// skip and the ragged edges are warp-uniform, so no wgmma sits behind a
// branch that ptxas cannot prove uniform (it would serialize every one,
// info C7520). Budget: 384 threads under __launch_bounds__(384, 1), 168
// registers at launch; setmaxnreg gives the producer warpgroup 24 a thread
// and the two consumers 240. At 128 the dK and dV accumulators take 128 of
// those, so the pair reads D after its products and the fused kernel's dQ
// sums pass through one box at a time (root PERF.md has ptxas's count).
//
// dQ in the fused kernel. The k-blocks of a q-block are held by different
// warpgroups and blocks of the grid, and dQ must be their block products
// added in k order from zero, dq = ((0 + p0) + p1) + ..., the additions
// of the split kernel (non-contracted __fadd_rn, no atomics). A block's
// first warpgroup (k-block 2 rt) waits (acquire) until the q-block's
// counter reads 2 rt, loads the f32 sum that k-block 2 rt - 1 stored in
// the accumulator [B*H, nq*64, DIM], adds its product and hands the sum
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
#include "flash_tile.cuh"

namespace {

struct Geometry {
  int B, H, Tq, Tk, offset;  // offset = Tk - Tq
  int causal;
  float scale;
};

// the last k-block that q-block qi visits; -1 when it sees none
__device__ __forceinline__ int last_kblock(int qi, const Geometry& g) {
  const int last = (g.Tk - 1) / kBlock;
  if (!g.causal) return last;
  const int reach = qi * kBlock + kBlock - 1 + g.offset;
  return reach < 0 ? -1 : min(last, reach / kBlock);
}

// the first q-block that k-block ki is visible to (some row of it sees a
// key of ki, `_causal_visible`)
__device__ __forceinline__ int first_qblock(int ki, const Geometry& g) {
  if (!g.causal) return 0;
  const int need = ki * kBlock - (kBlock - 1) - g.offset;
  return need <= 0 ? 0 : (need + kBlock - 1) / kBlock;
}

// ---- forward --------------------------------------------------------------

// The forward at head_dim DIM (64 or 128): a persistent grid over the
// (b*h, 192 or 128 query rows) tiles (`hopper::hopper_forward`). Layouts:
// q, out [B, Tq, H, DIM]; k, v [B, Tk, H, DIM], through tensor maps of q,
// k and v; lse [B, H, Tq] f32.
template <int DIM>
__global__ void __launch_bounds__(hopper::Fwd<DIM>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 const Geometry g) {
  extern __shared__ unsigned char hopper_smem[];
  const hopper::Segment seg{&k_map, &v_map, g.Tk, g.offset, g.causal};
  hopper::hopper_forward<DIM>(
      hopper_smem, &q_map, 1, [seg](int) { return seg; }, out, lse,
      g.B * g.H, g.H, g.Tq, g.scale);
}

// ---- backward -------------------------------------------------------------

// The three backward kernels (MODE): the split dQ kernel, the split
// dK/dV kernel, the one-pass kernel.
enum BwdMode { kBwdDq = 0, kBwdDkv = 1, kBwdFused = 2 };

// Compile-time choices of the backward at head_dim DIM. At 64, measured on
// the H100 at the training shapes (root PERF.md, Findings): three stages
// beat two by 5-9% on the split kernels (two were 2% faster on the fused
// one) and four, with more shared memory, were 11% slower on the fused
// kernel. At 128 a tile is two 64-column boxes (16 KB) and the fused
// chain's handed sums 32 KB a stage, so two stages and one round of
// resident blocks, ~210 KB.
template <int DIM>
struct Bwd {
  static_assert(DIM == 64 || DIM == 128,
                "the Hopper backward is built at head_dim 64 and 128");
  static constexpr int kHalves = DIM / 64;     // boxes of a row
  static constexpr int kConsumers = 2;         // resident blocks a tile
  static constexpr int kStages = DIM == 64 ? 3 : 2;   // streamed in flight
  static constexpr int kResBufs = DIM == 64 ? 2 : 1;  // tiles resident
  static constexpr int kThreads = 128 * kConsumers + 128;  // + the producer
  // at launch 65536 / 384 -> 168 a thread; setmaxnreg moves them
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr uint32_t kTileBytes = kBlock * DIM * sizeof(__nv_bfloat16);
  static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <=
                    launch_regs(kThreads) * kThreads,
                "setmaxnreg can only move the registers of the launch");
  static_assert(kConsumers == 2,
                "the fused dQ fold hands each sum from the first consumer "
                "warpgroup to the second");
  // Every tile 1024-byte aligned (the 128-byte swizzle's period). A `stat`
  // slot holds a q-block's lse (NEG_INF past Tq) then its D (0 past Tq).
  struct alignas(1024) Smem {
    // resident blocks of each consumer warpgroup, kResBufs work tiles
    // deep: K, V (dK/dV, fused) or Q, dO (dQ)
    __nv_bfloat16 res[kResBufs][kConsumers][2][kBlock * DIM];
    // streamed blocks: Q, dO (dK/dV, fused) or K, V (dQ)
    __nv_bfloat16 str[kStages][2][kBlock * DIM];
    __nv_bfloat16 ds[kConsumers][kBlock * kBlock];  // dS^T for dS K
    float hand[kStages][kBlock * DIM];  // fused: dQ sums handed on
    float res_stat[kResBufs][kConsumers][2 * kBlock];  // dQ
    float str_stat[kStages][2 * kBlock];               // dK/dV, fused
    uint64_t res_full[kResBufs], res_empty[kResBufs];
    uint64_t full[kStages], empty[kStages], hand_full[kStages];
  };
  static constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment
  static_assert(sizeof(Smem) > 232448 / 2,
                "one block an SM: the ordered dQ chain needs every block of "
                "the grid resident at once");
  static_assert(kSmemBytes <= 232448, "shared memory of one SM");
};

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

// The backward of [B, T, H, DIM] tensors (tensor maps of q, k, v and dO;
// lse, delta [B*H, Tq] f32): dq (kBwdDq), dk and dv (kBwdDkv), or all
// three (kBwdFused, with the f32 accumulator dq_acc [B*H, nq*64, DIM] and
// the zeroed counters dq_count [B*H*nq]). A persistent grid: block j
// takes work tiles j, j + gridDim.x, ...; the producer warp loads each
// tile's resident blocks and streams the other side's blocks, the two
// consumer warpgroups run `hopper::backward_pair` on every visible pair.
template <int DIM, int MODE>
__global__ void __launch_bounds__(Bwd<DIM>::kThreads, 1)
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
  using C = Bwd<DIM>;
  constexpr int kConsumers = C::kConsumers, kStages = C::kStages;
  constexpr int kResBufs = C::kResBufs, kHalves = C::kHalves;
  // q-blocks stream past resident k-blocks (dK/dV, fused), or the reverse
  constexpr bool kQStream = MODE != kBwdDq;
  extern __shared__ unsigned char hopper_smem[];
  typename C::Smem& s = *reinterpret_cast<typename C::Smem*>(
      (reinterpret_cast<uintptr_t>(hopper_smem) + 1023) & ~uintptr_t{1023});
  // the warpgroup, broadcast so that every branch on it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int heads = g.B * g.H;
  const int nq = (g.Tq + kBlock - 1) / kBlock;
  const int nk = (g.Tk + kBlock - 1) / kBlock;
  const int n_res = kQStream ? nk : nq;  // resident blocks a head
  const int per_head = (n_res + kConsumers - 1) / kConsumers;
  const int n_tiles = heads * per_head;
  // tile i: head i % heads; its blocks kConsumers * rt.. for rt = i /
  // heads ascending (k-blocks: the dQ chain's order) or, for dQ,
  // descending (the causally heaviest q-blocks first)
  const auto tile_at = [&](int i, int& bh, int& rt) {
    bh = i % heads;
    rt = kQStream ? i / heads : per_head - 1 - i / heads;
  };
  // the streamed blocks a tile visits: those some resident block sees
  const auto stream_range = [&](int rt, int& first, int& last) {
    const int lo = rt * kConsumers;
    if (kQStream) {
      first = first_qblock(lo, g);
      last = nq - 1;
    } else {
      first = 0;
      last = last_kblock(min(lo + kConsumers - 1, nq - 1), g);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kResBufs; ++i) {
      mbar_init(&s.res_full[i], 33);  // expect_tx + the 32 producer lanes
      mbar_init(&s.res_empty[i], 128 * kConsumers);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 33);
      mbar_init(&s.empty[i], 128 * kConsumers);
      mbar_init(&s.hand_full[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one warp; lane 0 starts the TMA loads, every lane loads
    // its share of lse and D and arrives on the stage's full barrier
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        C::kProducerRegs));
    if (threadIdx.x >= 128 * kConsumers + 32) return;
    const int lane = threadIdx.x & 31;
    int it = 0, round = 0;
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x, ++round) {
      int bh, rt, first, last;
      tile_at(i, bh, rt);
      stream_range(rt, first, last);
      const int b = bh / g.H, h = bh % g.H;
      const int buf = round % kResBufs;
      const int held = min(kConsumers, n_res - rt * kConsumers);
      mbar_wait(&s.res_empty[buf], ((round / kResBufs) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&s.res_full[buf], held * 2 * C::kTileBytes);
        for (int w = 0; w < held; ++w) {
          const int row = (rt * kConsumers + w) * kBlock;
          tma_load_tile<DIM>(s.res[buf][w][0], kQStream ? &k_map : &q_map,
                             &s.res_full[buf], h, row, b);
          tma_load_tile<DIM>(s.res[buf][w][1], kQStream ? &v_map : &do_map,
                             &s.res_full[buf], h, row, b);
        }
      }
      if (!kQStream)
        for (int w = 0; w < held; ++w)
          load_stats(s.res_stat[buf][w], lse, delta, bh,
                     (rt * kConsumers + w) * kBlock, g.Tq, lane);
      mbar_arrive(&s.res_full[buf]);
      for (int j = first; j <= last; ++j, ++it) {
        const int st = it % kStages;
        mbar_wait(&s.empty[st], ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&s.full[st], 2 * C::kTileBytes);
          tma_load_tile<DIM>(s.str[st][0], kQStream ? &q_map : &k_map,
                             &s.full[st], h, j * kBlock, b);
          tma_load_tile<DIM>(s.str[st][1], kQStream ? &do_map : &v_map,
                             &s.full[st], h, j * kBlock, b);
        }
        if (kQStream)
          load_stats(s.str_stat[st], lse, delta, bh, j * kBlock, g.Tq, lane);
        mbar_arrive(&s.full[st]);
      }
    }
    return;
  }

  // consumer warpgroup wg: resident block rt * kConsumers + wg
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      C::kConsumerRegs));
  const int t = threadIdx.x & 127, lane = t & 31;
  // this thread's rows r0, r0 + 8 and columns c0, c0 + 1 of each 8-column
  // block of a 64x64 accumulator (element i: row r0 + 8 ((i >> 1) & 1),
  // column 8 (i >> 2) + c0 + (i & 1)); a 64-column box of DIM each
  const int r0 = 16 * (t >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
  const BwdMask mask{g.Tk, g.offset, g.causal};
  const uint64_t ds_desc = tile_desc(s.ds[wg]);
  int it = 0, round = 0;
  for (int i = blockIdx.x; i < n_tiles; i += gridDim.x, ++round) {
    int bh, rt, first, last;
    tile_at(i, bh, rt);
    stream_range(rt, first, last);
    const int b = bh / g.H, h = bh % g.H;
    const int buf = round % kResBufs;
    const int mine = rt * kConsumers + wg;  // -> n_res: no block
    // the streamed blocks this warpgroup's block sees: [lo, hi]
    int lo = 1, hi = 0;
    if (mine < n_res) {
      lo = kQStream ? first_qblock(mine, g) : 0;
      hi = kQStream ? nq - 1 : last_kblock(mine, g);
    }
    const __nv_bfloat16* res0 = s.res[buf][wg][0];
    const __nv_bfloat16* res1 = s.res[buf][wg][1];
    // dV and dK (dK/dV, fused), or dQ (dQ: acc_a only), a box each half
    float acc_a[kHalves][32], acc_b[kHalves][32];
#pragma unroll
    for (int half = 0; half < kHalves; ++half)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc_a[half][e] = acc_b[half][e] = 0.f;

    // The fused kernel's dQ fold, one 64-column box (half) at a time. The
    // first warpgroup (k-block 2 rt) acquires k-block 2 rt - 1's sum of the
    // q-block while its S^T and dP^T run (`meanwhile`, which at 64 also
    // loads it; at 128 each box is loaded as it is folded), adds its block
    // product, and hands the sum to the second warpgroup (k-block 2 rt +
    // 1) through shared memory (`hand`, each thread its own values;
    // `hand_full`, one phase a streamed block), or writes bf16 dQ where it
    // is the q-block's last k-block. The second adds its own and stores
    // the sum for the next tile's first warpgroup, or writes bf16 dQ; it
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
    // box `half` of the f32 sum [64][DIM] at `sum` into prev
    const auto load_sum = [&](const float* sum, int half) {
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const float2 x = __ldcg(reinterpret_cast<const float2*>(
            sum + (r0 + 8 * (jj & 1)) * DIM + 64 * half + 8 * (jj >> 1) +
            c0));
        prev[2 * jj] = x.x;
        prev[2 * jj + 1] = x.y;
      }
    };
    mbar_wait(&s.res_full[buf], (round / kResBufs) & 1);

    for (int j = first; j <= last; ++j, ++it) {
      const int st = it % kStages;
      mbar_wait(&s.full[st], (it / kStages) & 1);
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
      float* sum = dq_acc + pair * (kBlock * DIM);
      const auto meanwhile = [&] {
        if (MODE != kBwdFused) return;
        publish();
        if (wg != 0 || mine == 0) return;
        wait_count(dq_count + pair, mine);
        if (kHalves == 1) load_sum(sum, 0);
      };
      uint32_t p[16], ds[16];
      constexpr bool kStage = MODE != kBwdDkv;
      if (k0 + kBlock > g.Tk || (g.causal && q0 + g.offset < k0 + kBlock - 1))
        backward_pair<DIM, true, kStage>(k_desc, v_desc, q_desc, do_desc,
                                         stats, s.ds[wg], wg, k0, q0, mask,
                                         g.scale, p, ds, meanwhile);
      else
        backward_pair<DIM, false, kStage>(k_desc, v_desc, q_desc, do_desc,
                                          stats, s.ds[wg], wg, k0, q0, mask,
                                          g.scale, p, ds, meanwhile);
      const bool last_k = MODE == kBwdFused && mine == last_kblock(j, g);
#pragma unroll
      for (int half = 0; half < kHalves; ++half) {
        float blk[32];
        wgmma_fence();
        if (MODE != kBwdDq && half == 0)
          start_dkv(acc_a, acc_b, p, ds, do_desc, q_desc);
        if (MODE != kBwdDkv) start_dq(blk, ds_desc, k_desc + half * kBoxStep);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh) {
          hold(acc_a[hh]);
          hold(acc_b[hh]);
        }
        if (MODE == kBwdDkv) break;
        hold(blk);
        if (MODE == kBwdDq) {
#pragma unroll
          for (int e = 0; e < 32; ++e)
            acc_a[half][e] = __fadd_rn(acc_a[half][e], blk[e]);
          continue;
        }
        // the fused fold of this box
        float* hand = s.hand[st] + half * (32 * 128);
        if (wg != 0) {
          if (half == 0) mbar_wait(&s.hand_full[st], (it / kStages) & 1);
#pragma unroll
          for (int e = 0; e < 32; ++e) prev[e] = hand[e * 128 + t];
        } else if (mine == 0) {
#pragma unroll
          for (int e = 0; e < 32; ++e) prev[e] = 0.f;
        } else if (kHalves > 1) {  // at 64 loaded in `meanwhile`
          load_sum(sum, half);
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) prev[e] = __fadd_rn(prev[e], blk[e]);
        if (last_k) {
          // the q-block's last k-block: dQ in bf16
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = q0 + r0 + 8 * r;
            if (row >= g.Tq) continue;
            __nv_bfloat16* dst =
                dq + row_at<DIM>(b, row, h, g.Tq, g.H) + 64 * half + c0;
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
#pragma unroll
          for (int jj = 0; jj < 16; ++jj)
            __stcg(reinterpret_cast<float2*>(sum + (r0 + 8 * (jj & 1)) * DIM +
                                             64 * half + 8 * (jj >> 1) + c0),
                   make_float2(prev[2 * jj], prev[2 * jj + 1]));
        }
      }
      if (MODE == kBwdFused) {
        if (wg != 0 && !last_k) {
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
        const size_t at = row_at<DIM>(b, row, h, T, g.H) + c0;
#pragma unroll
        for (int half = 0; half < kHalves; ++half)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int e = 4 * jj + 2 * r;
            const size_t col = at + 64 * half + 8 * jj;
            if (kQStream) {
              *reinterpret_cast<__nv_bfloat162*>(dk + col) =
                  __floats2bfloat162_rn(acc_b[half][e], acc_b[half][e + 1]);
              *reinterpret_cast<__nv_bfloat162*>(dv + col) =
                  __floats2bfloat162_rn(acc_a[half][e], acc_a[half][e + 1]);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(dq + col) =
                  __floats2bfloat162_rn(acc_a[half][e], acc_a[half][e + 1]);
            }
          }
      }
      // fused: k-block 0 writes zero dQ for the q-blocks that see no key
      if (MODE == kBwdFused && mine == 0) {
        const int empty_rows = min(first_qblock(0, g) * kBlock, g.Tq);
        for (int row = t; row < empty_rows; row += 128)
          for (int c = 0; c < DIM; c += 8)
            *reinterpret_cast<uint4*>(
                dq + row_at<DIM>(b, row, h, g.Tq, g.H) + c) =
                make_uint4(0u, 0u, 0u, 0u);
      }
    }
    mbar_arrive(&s.res_empty[buf]);
  }
}

// ---- host -------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// a cudaError_t, or hopper::kTensorMapError + a CUresult
template <int DIM>
int forward(const void* q, const void* k, const void* v, void* out,
            float* lse, const Geometry& g, cudaStream_t stream) {
  using F = hopper::Fwd<DIM>;
  CUtensorMap q_map, k_map, v_map;
  int err = hopper::encode_rows<DIM>(&q_map, q, g.B, g.Tq, g.H);
  if (err == 0) err = hopper::encode_rows<DIM>(&k_map, k, g.B, g.Tk, g.H);
  if (err == 0) err = hopper::encode_rows<DIM>(&v_map, v, g.B, g.Tk, g.H);
  if (err != 0) return err;
  err = allow_smem(flash_fwd_kernel<DIM>, F::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int blocks = hopper::persistent_blocks(g.B * g.H * F::q_tiles(g.Tq));
  flash_fwd_kernel<DIM><<<blocks, F::kThreads, F::kSmemBytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, g);
  return cudaGetLastError();
}

// a cudaError_t, or hopper::kTensorMapError + a CUresult
template <int DIM, int MODE>
int backward(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, void* dk,
             void* dv, float* dq_acc, unsigned* dq_count, const Geometry& g,
             cudaStream_t stream) {
  using C = Bwd<DIM>;
  CUtensorMap q_map, k_map, v_map, do_map;
  int err = hopper::encode_rows<DIM>(&q_map, q, g.B, g.Tq, g.H);
  if (err == 0) err = hopper::encode_rows<DIM>(&k_map, k, g.B, g.Tk, g.H);
  if (err == 0) err = hopper::encode_rows<DIM>(&v_map, v, g.B, g.Tk, g.H);
  if (err == 0) err = hopper::encode_rows<DIM>(&do_map, dout, g.B, g.Tq, g.H);
  if (err != 0) return err;
  auto kernel = flash_bwd_hopper_kernel<DIM, MODE>;
  if ((err = allow_smem(kernel, C::kSmemBytes)) != cudaSuccess) return err;
  const int n_res = ((MODE == kBwdDq ? g.Tq : g.Tk) + kBlock - 1) / kBlock;
  const int blocks = hopper::persistent_blocks(
      g.B * g.H * ((n_res + C::kConsumers - 1) / C::kConsumers));
  using bf16 = __nv_bfloat16;
  kernel<<<blocks, C::kThreads, C::kSmemBytes, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), dq_acc, dq_count, g);
  return cudaGetLastError();
}

template <int DIM>
int backward_at(int kind, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, float* dq_acc,
                unsigned* dq_count, const Geometry& g, cudaStream_t s) {
  const auto run = kind == kBwdDq    ? &backward<DIM, kBwdDq>
                   : kind == kBwdDkv ? &backward<DIM, kBwdDkv>
                                     : &backward<DIM, kBwdFused>;
  return run(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, dq_count, g, s);
}

// The shapes these kernels take: head_dim 64 or 128, and grids that fit
bool valid(int B, int H, int Tq, int Tk, int D) {
  return B >= 1 && H >= 1 && Tq >= 1 && Tk >= 1 && (D == 64 || D == 128) &&
         static_cast<long long>(B) * H * ((Tq + kBlock - 1) / kBlock) <=
             0x7fffffffLL &&
         static_cast<long long>(B) * H * ((Tk + kBlock - 1) / kBlock) <=
             0x7fffffffLL;
}

}  // namespace

// The forward of bf16 [B, T, H, D] tensors, D 64 or 128. Returns a
// cudaError_t (0 = launched), or for a refused tensor map
// hopper::kTensorMapError + its CUresult.
extern "C" int flashy_flash_forward(const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    int B, int H, int Tq, int Tk, int D,
                                    int causal, float scale, void* stream) {
  if (!valid(B, H, Tq, Tk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{B, H, Tq, Tk, Tk - Tq, causal ? 1 : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? forward<64>(q, k, v, out, lse, g, s)
                 : forward<128>(q, k, v, out, lse, g, s);
}

// kind: 0 split dQ (writes dq), 1 split dK/dV (dk, dv), 2 fused (dq, dk,
// dv, with `scratch` its f32 accumulator [B*H, nq*64, D] and `counts`
// [B*H*nq] zeroed). bf16 tensors, D 64 or 128. Returns a cudaError_t (0 =
// launched), or for a refused tensor map hopper::kTensorMapError + its
// CUresult.
extern "C" int flashy_flash_backward(int kind, const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dq, void* dk, void* dv,
                                     float* scratch, unsigned* counts, int B,
                                     int H, int Tq, int Tk, int D, int causal,
                                     float scale, void* stream) {
  if (kind < 0 || kind > 2 || !valid(B, H, Tq, Tk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{B, H, Tq, Tk, Tk - Tq, causal ? 1 : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? backward_at<64>(kind, q, k, v, dout, lse, delta, dq, dk,
                                   dv, scratch, counts, g, s)
                 : backward_at<128>(kind, q, k, v, dout, lse, delta, dq, dk,
                                    dv, scratch, counts, g, s);
}
