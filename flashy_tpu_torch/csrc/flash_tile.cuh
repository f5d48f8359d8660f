// Tile code shared by the bf16 flash-attention kernels (flash_attention.cu)
// and the bf16 ring-attention kernel (ring_attention.cu), on Hopper
// (namespace `hopper`). The f32 kernels, and the bf16 ones at other head
// dims, are flash_general.cu's.
//
// 1. The bf16 forward (`hopper_forward`), which both bf16 forwards run. A
//    persistent grid, one block an SM, walks the work tiles (a tile's query
//    rows of one (b, h); heads fastest, the q-tiles last first). A block is
//    consumer warpgroups of 64 rows and one producer warpgroup. The
//    producer's one thread loads a tile's Q once and K/V 64 keys at a time
//    with TMA (`cp.async.bulk.tensor`, tensor maps over the [B, T, H, D]
//    layout, 64x64 boxes, 128-byte swizzle, rows past T zero-filled) into a
//    ring of kStages bf16 K/V tiles guarded by mbarrier full/empty pairs,
//    and goes on to the next tile's Q and K/V while the consumers finish
//    the current one. Each consumer warpgroup runs S = Q K^T as wgmma
//    m64n64k16 with both operands in shared memory, the online softmax in
//    the accumulator layout (a thread holds 2 rows x 16 keys; a row's max
//    and sum take two quad shuffles; m and l stay in registers; no shared
//    memory and no block barrier per step; the mask only on a diagonal or
//    ragged tile), then P V as wgmma with P packed from the S accumulators
//    into bf16 A fragments in registers and V read as an MN-major operand
//    (no transpose copy). The loop is software-pipelined: Q K^T of tile j
//    and P V of tile j-1 are on the tensor cores while the warpgroup runs
//    the softmax of tile j.
// 2. The bf16 backward's pair step (`backward_pair`, `start_dkv`,
//    `start_dq`), which the three bf16 backward kernels of
//    flash_attention.cu run (their skeleton, the persistent grid, the TMA
//    ring and the fused kernel's ordered dQ chain, with why that chain
//    cannot hang, are described there). For one (64 keys, 64 queries)
//    pair, FA3's orientation: S^T = K Q^T and dP^T = V dO^T as wgmma with
//    the keys as M, so that P^T and dS^T come out in the accumulator
//    layout, which is the A-fragment layout of dV += P^T dO and dK +=
//    dS^T Q (dO and Q MN-major, as V is in the forward); dK and dV
//    accumulate in place inside the wgmma. dQ = dS K is a block product
//    from zero with dS^T staged once in swizzled shared memory and read
//    as an MN-major A operand. lse and D are per column, the mask only on
//    a diagonal or ragged pair. P is rounded to bf16 before P^T dO, dS =
//    P (dP - D) scale (from the f32 P) before dS^T Q and dS K. Because
//    every bf16 backward kernel runs this one step, fused and split stay
//    bit-equal; the step's sums inside a row are wgmma's, not the plain
//    version's, so the kernels are held to it at the FLASH_TOL bars.
//    What bounds it: at the bound, operations (10 D flops a visible
//    pair of the fused kernel); in fact the warpgroup's f32 instruction
//    rate on P and dS (the exact expf ~8 instructions an element; a dead
//    query's guard is a per-column +inf, not a select per element, which
//    alone took a third off every backward kernel) and, in the fused
//    kernel, the ordered dQ chain's round trips to L2, with the other
//    consumer warpgroup's products overlapping them.
//
// Both steps are built at head_dim 64 and 128 (DIM). A row of DIM columns
// is DIM / 64 swizzle atoms: one 64x64 TMA box each, stored one after the
// other, so that the products contracting over the head dim step from box
// to box (`start_qk`) and those whose output spans it run one m64n64
// wgmma a box, each into its own accumulator (`start_pv`, `start_dkv`,
// `start_dq`).
//
// The bf16 forward computes the function of the f32 forward
// (flash_general.cu): the online softmax steps once per 64 keys, scores
// are q.k * scale with __fmul_rn, the running max moves past NEG_INF/2
// only (the guarded exp, expf of an __fsub_rn), P is rounded to bf16
// once before P.V, and P.V is a block product from zero that the
// accumulator takes as acc * alpha + pv with non-contracted f32
// arithmetic (accumulating P V in place, inside the wgmma, moved more
// outputs off the reference and was slower). Only the order of the sums
// inside a row differs (wgmma's against FMAs in ascending order), as it
// differs from the plain version's. The flash and ring forwards run the
// same step, so a one-rank ring is bit-equal to the flash forward over
// the same keys.
//
// What bounds the forward on this card: at the bound, operations (4 D
// flops per visible (query, key) pair at the tensor cores' bf16 rate;
// the training shapes' forward is ~4x above the ~295 flops a byte where
// the H100 leaves the memory bound). In fact the rate at which the
// schedulers dispatch the softmax: ~15 f32 instructions an element (expf
// alone ~8: the accurate expf that torch.exp matches, not an exp2
// shortcut), ~560 a warp and a 64-key tile, with three consumer warps
// sharing each scheduler; the tensor cores idle most of the time. Budget
// at 64 (ptxas -v, sm_90a): 512 threads a block under
// __launch_bounds__(512, 1), 128 registers at launch, 0 bytes spilled;
// setmaxnreg gives the producer warpgroup 32 registers a thread and the
// three consumers 160, the whole register file; shared memory 24 KB of Q
// and kStages x 16 KB of K/V (4 stages: 88 KB and the barriers), so one
// block per SM. A 192-row tile leaves a third of its last q-tile idle at
// T = 1024 and 512, and still beats 128 rows there. At 128: two consumer
// warpgroups (128-row tiles; the accumulator and the pending P V take 64
// registers each), ~162 KB of shared memory, 384 threads, 168 registers
// at launch, setmaxnreg 24 for the producer and 240 for the consumers.
// setmaxnreg only moves registers within what the launch gave the block
// (`launch_regs`): asking for more, 32 + 2 x 240 a thread of each
// warpgroup against 3 x 168, never returns. No branch around a wgmma may
// look divergent to ptxas, or it serializes every wgmma (C7520): the
// warpgroup index is broadcast with __shfl_sync and the mbarrier spin
// loop is one PTX block. Still left: overlap of one warpgroup's softmax
// with another's products that pays (a ping-pong on mbarrier turns was
// slower), TMA stores of the output, and one grid for all ranks of a
// ring.
#pragma once
#include <cuda.h>  // CUtensorMap and its enums; no -lcuda (see
                   // `tensor_map_encoder`)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlock = 64;  // q and k tile (FLASH_BLOCK), and a box's columns

// first element of row (b, t, h) of a contiguous [B, T, H, DIM] tensor
template <int DIM>
__device__ __forceinline__ size_t row_at(int b, int t, int h, int T, int H) {
  return ((static_cast<size_t>(b) * T + t) * H + h) * DIM;
}

// two f32 values rounded to bf16 (to nearest even) as one bf16x2
// register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// registers a thread of a kThreads-thread block gets at launch when one
// block holds the SM's 65536 (allocated in units of 8); setmaxnreg moves
// them between warpgroups and cannot add to them
__host__ __device__ constexpr int launch_regs(int threads) {
  return 65536 / threads / 8 * 8;
}

// ---------------------------------------------------------------------
// The bf16 forward on Hopper: TMA, mbarriers, wgmma, register softmax.
// ---------------------------------------------------------------------
namespace hopper {

using bf16 = __nv_bfloat16;

// Compile-time choices, measured on the H100 at the training shapes (root
// PERF.md, Findings): at head_dim 64 three consumer warpgroups (192-row
// tiles) beat two by ~5% and one (64 rows, two blocks an SM) by more;
// four K/V stages beat three by ~2% and two by ~20%. At head_dim 128 a
// row is two 64-column swizzle atoms (two TMA boxes, two m64n64 halves of
// P V), and the accumulator and the pending P V take 64 registers each,
// so two consumer warpgroups (128-row tiles).
constexpr int kRows = 64;                   // query rows of a warpgroup
constexpr int kStages = 4;                  // K/V tiles in flight
constexpr uint32_t kBoxBytes = kBlock * 64 * sizeof(bf16);  // a box, 8 KB

template <int DIM>
struct Fwd {
  static_assert(DIM == 64 || DIM == 128,
                "the Hopper forward is built at head_dim 64 and 128");
  static constexpr int kHalves = DIM / 64;      // swizzle atoms of a row
  static constexpr int kConsumers = DIM == 64 ? 3 : 2;
  static constexpr int kQTile = kRows * kConsumers;  // query rows a block
  static constexpr int kThreads = 128 * (kConsumers + 1);  // + producer
  // registers a thread after setmaxnreg, moved from the producer to the
  // consumers: at 64 the 128 a thread of the launch (512 threads), at 128
  // the 168 (384 threads)
  static constexpr int kProducerRegs = DIM == 64 ? 32 : 24;
  static constexpr int kConsumerRegs = DIM == 64 ? 160 : 240;
  static constexpr uint32_t kTileBytes = kBlock * DIM * sizeof(bf16);
  static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <=
                    launch_regs(kThreads) * kThreads,
                "setmaxnreg can only move the registers of the launch");
  // Every tile 1024-byte aligned: the 128-byte swizzle repeats every 8
  // rows of 128 bytes, and TMA and the wgmma descriptors agree on it only
  // from such a base. A tile of DIM columns is kHalves 64-column boxes.
  struct alignas(1024) Smem {
    bf16 q[kConsumers][kBlock * DIM];
    bf16 k[kStages][kBlock * DIM];
    bf16 v[kStages][kBlock * DIM];
    uint64_t q_full, q_empty;
    uint64_t k_full[kStages], v_full[kStages], empty[kStages];
  };
  static constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment
  // query tiles of a block each over T rows
  __host__ __device__ static int q_tiles(int T) {
    return (T + kQTile - 1) / kQTile;
  }
};

// Returned by the C entry points for a tensor map that
// cuTensorMapEncodeTiled refused: kTensorMapError + its CUresult
// (cudaError_t values stay below it).
constexpr int kTensorMapError = 1000000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// Until the phase of parity `parity` has completed. The spin loop is one
// PTX block, so the compiler does not see a divergent C++ loop in front
// of every wgmma (it then serializes them, ptxas C7520). A phase that
// never completes is a bug of the kernel: after ~10 s of clock the
// thread traps, which the caller sees as a launch failure, instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p, late;\n.reg .s64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra LAB_DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.s64 t1, t1, t0;\n"
      "setp.gt.s64 late, t1, 20000000000;\n"
      "@late trap;\n"
      "bra LAB_WAIT;\n"
      "LAB_DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one 64x64 box, rows t.. and columns d0.. of head (b, h), into `dst`;
// completes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int t, int b,
                                         int d0 = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(t), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// a DIM-column tile (DIM / 64 boxes, one after another), rows t.. of head
// (b, h)
template <int DIM>
__device__ __forceinline__ void tma_load_tile(bf16* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int h, int t,
                                              int b) {
#pragma unroll
  for (int half = 0; half < DIM / 64; ++half)
    tma_load(dst + half * kBlock * 64, map, bar, h, t, b, half * 64);
}

// wgmma descriptor of a 64x64 bf16 tile as TMA wrote it: 128-byte rows,
// 128-byte swizzle (layout type 1), 8-row groups 1024 bytes apart. That
// stride is the SBO of the K-major operands (Q, K: rows along M or N) and
// of the MN-major V (rows along K); the LBO, which the K-major form does
// not read and the MN-major form reads only past one 64-column swizzle
// atom, is set to the same.
__device__ __forceinline__ uint64_t tile_desc(const bf16* tile) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return (static_cast<uint64_t>(smem_u32(tile)) >> 4) | (kGroup << 16) |
         (kGroup << 32) | (uint64_t{1} << 62);
}
// descriptor offsets (16-byte units) of the k-th 16-deep slice: 32 bytes
// along a K-major row, 16 rows of 128 bytes down the MN-major V; and of
// the next 64-column box of a wider tile
constexpr uint64_t kKMajorStep = 32 >> 4, kMNMajorStep = 2048 >> 4;
constexpr uint64_t kBoxStep = kBoxBytes >> 4;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of `r` across a wgmma's wait
__device__ __forceinline__ void hold(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B, m64n64k16, A and B in shared memory; K-major by default,
// MN-major (the transpose flags) where kTransA / kTransB is 1
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d (+)= A B, m64n64k16, A in registers (bf16 fragments), B in shared
// memory MN-major (the transpose flag)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// One key segment of the online softmax: a [B, Tk, H, DIM] K/V pair
// (tensor maps `k`, `v`) visited 64 keys at a time from key 0. Key
// k_pos is hidden from query q_pos where k_pos >= Tk or, under causal,
// q_pos + offset < k_pos. The flash forward has one segment; the ring
// one per visible ring step.
struct Segment {
  const CUtensorMap* k;
  const CUtensorMap* v;
  int Tk, offset, causal;

  // the last tile that query rows up to `row` see; -1 for none
  __device__ __forceinline__ int last_tile(int row) const {
    const int last = (Tk - 1) / kBlock;
    if (!causal) return last;
    const int reach = row + offset;
    return reach < 0 ? -1 : min(last, reach / kBlock);
  }
};

// S = Q K^T of one 64-key tile: DIM / 16 k16 slices (four a 64-column
// box), started, not waited
template <int DIM>
__device__ __forceinline__ void start_qk(float (&sc)[32], uint64_t q_desc,
                                         uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < DIM / 16; ++kk) {
    const uint64_t at = (kk >> 2) * kBoxStep + (kk & 3) * kKMajorStep;
    wgmma_ss(sc, q_desc + at, k_desc + at, kk);
  }
}

// P V from zero: P in bf16 A fragments, four k16 slices of V, for each
// 64-column box of V into its own accumulator; started, not waited
template <int HALVES>
__device__ __forceinline__ void start_pv(float (&pv)[HALVES][32],
                                         const uint32_t (&p)[16],
                                         uint64_t v_desc) {
#pragma unroll
  for (int half = 0; half < HALVES; ++half)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(pv[half], p + 4 * kk,
               v_desc + half * kBoxStep + kk * kMNMajorStep, kk);
}

// acc = acc * alpha + pv, per row, non-contracted
template <int HALVES>
__device__ __forceinline__ void accumulate(float (&acc)[HALVES][32],
                                           const float (&pv)[HALVES][32],
                                           const float (&alpha)[2]) {
#pragma unroll
  for (int half = 0; half < HALVES; ++half)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[half][i] = __fadd_rn(__fmul_rn(acc[half][i], alpha[(i >> 1) & 1]),
                               pv[half][i]);
}

// One 64-key step of the online softmax on S in the accumulator layout
// (element i at row r0 + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + c0 +
// (i & 1)): scale, mask where EDGE (some key of the tile is hidden from
// some row of the warpgroup), the running max m, alpha = exp(m_old -
// m_new), P = the guarded exp in place of S (f32), l = l alpha + sum P.
// A row whose max is still <= NEG_INF/2 subtracts +inf instead of its
// max, so its P is exactly 0, as the guard's select would make it.
template <bool EDGE>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2],
                                             const Segment& seg, int r0,
                                             int k0, int c0, float scale) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    bool shown = true;
    if (EDGE) {
      const int row = r0 + 8 * ((i >> 1) & 1);
      const int col = k0 + 8 * (i >> 2) + c0 + (i & 1);
      shown = col < seg.Tk && (!seg.causal || row + seg.offset >= col);
    }
    sc[i] = shown ? __fmul_rn(sc[i], scale) : kNegInf;
  }
  float mx[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
#pragma unroll
  for (int i = 0; i < 32; ++i)
    mx[(i >> 1) & 1][i & 1] = fmaxf(mx[(i >> 1) & 1][i & 1], sc[i]);
  float sub[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(mx[r][0], mx[r][1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[r], x);
    alpha[r] = expf(__fsub_rn(m[r], m_new));
    m[r] = m_new;
    sub[r] = m_new > kNegInf * 0.5f ? m_new : __int_as_float(0x7f800000);
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = expf(__fsub_rn(sc[i], sub[(i >> 1) & 1]));
    sum[(i >> 1) & 1][i & 1] = __fadd_rn(sum[(i >> 1) & 1][i & 1], sc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = __fadd_rn(sum[r][0], sum[r][1]);
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
    l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), x);
  }
}

// One work tile of the persistent grid: query rows q0..q0+kQTile-1 of
// head (b, h).
struct Tile {
  int b, h, q0;
};

// Tile i of the heads x q_tiles(T) tiles: heads fastest and the q-tiles
// last first, so that under causal the heaviest tiles come first and the
// launch's tail is short. (Walking one head's q-tiles side by side reads
// its K/V from device memory once instead of once a q-tile, but puts the
// heavy tiles of the last heads last; on the H100 it was no faster, see
// root PERF.md.)
template <int DIM>
__device__ __forceinline__ Tile tile_at(int i, int heads, int H, int T) {
  const int bh = i % heads, qi = Fwd<DIM>::q_tiles(T) - 1 - i / heads;
  return Tile{bh / H, bh % H, qi * Fwd<DIM>::kQTile};
}

// The bf16 forward of a [B, Tq, H, DIM] tensor (tensor map `q_map`, heads
// = B*H) over the segments(0..n_seg-1) in order: for every query row one
// online softmax across all of them, out [B, Tq, H, DIM] in bf16 and lse
// [B*H, Tq] f32. A persistent grid: block j takes tiles j, j + gridDim.x,
// ... (`tile_at`), and its producer loads the next tile's Q and K/V while
// the consumers finish the current one. `raw` is the block's dynamic
// shared memory, Fwd<DIM>::kSmemBytes of it; the block has
// Fwd<DIM>::kThreads threads.
template <int DIM, typename Segments>
__device__ __forceinline__ void hopper_forward(
    unsigned char* raw, const CUtensorMap* q_map, int n_seg,
    Segments segment, bf16* __restrict__ out, float* __restrict__ lse,
    int heads, int H, int Tq, float scale) {
  using F = Fwd<DIM>;
  constexpr int kConsumers = F::kConsumers, kQTile = F::kQTile;
  constexpr int kHalves = F::kHalves;
  using Smem = typename F::Smem;
  Smem& s = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t{1023});
  // the warpgroup, broadcast from lane 0 so that the compiler knows every
  // branch on it is warp-uniform (wgmma in a branch it cannot prove
  // uniform is serialized)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int n_tiles = heads * F::q_tiles(Tq);
  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    mbar_init(&s.q_empty, 128 * kConsumers);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.k_full[i], 1);
      mbar_init(&s.v_full[i], 1);
      mbar_init(&s.empty[i], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread starts every load; `it` counts K/V tiles and
    // `round` this block's work tiles, over the whole launch
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        F::kProducerRegs));
    if (threadIdx.x != 128 * kConsumers) return;
    int it = 0, round = 0;
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x, ++round) {
      const Tile tile = tile_at<DIM>(i, heads, H, Tq);
      const int q_hi = min(tile.q0 + kQTile, Tq) - 1;  // the tile's last row
      // Q once every S of the previous tile is done
      mbar_wait(&s.q_empty, (round & 1) ^ 1);
      const int halves = (q_hi - tile.q0) / kRows + 1;  // tiles holding a row
      mbar_expect_tx(&s.q_full, halves * F::kTileBytes);
      for (int j = 0; j < halves; ++j)
        tma_load_tile<DIM>(s.q[j], q_map, &s.q_full, tile.h,
                           tile.q0 + j * kRows, tile.b);
      for (int sg = 0; sg < n_seg; ++sg) {
        const Segment seg = segment(sg);
        const int last = seg.last_tile(q_hi);
        for (int ki = 0; ki <= last; ++ki, ++it) {
          const int st = it % kStages;
          mbar_wait(&s.empty[st], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&s.k_full[st], F::kTileBytes);
          tma_load_tile<DIM>(s.k[st], seg.k, &s.k_full[st], tile.h,
                             ki * kBlock, tile.b);
          mbar_expect_tx(&s.v_full[st], F::kTileBytes);
          tma_load_tile<DIM>(s.v[st], seg.v, &s.v_full[st], tile.h,
                             ki * kBlock, tile.b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      F::kConsumerRegs));
  const int t = threadIdx.x & 127, lane = t & 31;
  // this thread's rows r0 and r0 + 8, and its columns c0, c0 + 1 of each
  // 8-column block of a 64x64 accumulator: element i sits at row
  // r0 + 8 ((i >> 1) & 1), column 8 (i >> 2) + c0 + (i & 1)
  const int c0 = 2 * (lane & 3);
  const uint64_t q_desc = tile_desc(s.q[wg]);
  // Software pipeline over the warpgroup's K/V tiles: the iteration of
  // tile j starts Q K_j^T and the P V of the tile before it (`pend`), runs
  // the softmax of tile j while both are on the tensor cores, then folds
  // the earlier P V into acc and releases that tile's stage. P of tile j
  // waits in `p` for the next iteration (or the drain). Each 64-column box
  // of the output has its own accumulator (acc[half], pv[half]).
  float acc[kHalves][32], sc[32], pv[kHalves][32], m[2], l[2],
      pend_alpha[2];
  uint32_t p[16];
  int pend = -1;  // stage of the tile whose P V is still to do; -1 none
  const auto hold_pv = [&] {
#pragma unroll
    for (int half = 0; half < kHalves; ++half) hold(pv[half]);
  };
  const auto drain = [&] {
    if (pend < 0) return;
    wgmma_fence();
    start_pv(pv, p, tile_desc(s.v[pend]));
    wgmma_commit();
    wgmma_wait<0>();
    hold_pv();
    accumulate(acc, pv, pend_alpha);
    mbar_arrive(&s.empty[pend]);
    pend = -1;
  };
  int it = 0, round = 0;
  for (int i = blockIdx.x; i < n_tiles; i += gridDim.x, ++round) {
    const Tile tile = tile_at<DIM>(i, heads, H, Tq);
    const int q_hi = min(tile.q0 + kQTile, Tq) - 1;
    const int q0w = tile.q0 + wg * kRows;
    const int row_hi = min(q0w + kRows, Tq) - 1;  // < q0w: no row here
    const int r0 = q0w + 16 * (t >> 5) + (lane >> 2);
#pragma unroll
    for (int half = 0; half < kHalves; ++half)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[half][j] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
    if (row_hi >= q0w) mbar_wait(&s.q_full, round & 1);

    for (int sg = 0; sg < n_seg; ++sg) {
      const Segment seg = segment(sg);
      const int last = seg.last_tile(q_hi);
      const int mine = row_hi >= q0w ? seg.last_tile(row_hi) : -1;
      for (int ki = 0; ki <= last; ++ki, ++it) {
        const int st = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        if (ki > mine) {
          // a tile only the other warpgroup sees: finish the pipeline (so
          // that stages go back in order), let this one go once it landed
          drain();
          mbar_wait(&s.k_full[st], parity);
          mbar_wait(&s.v_full[st], parity);
          mbar_arrive(&s.empty[st]);
          continue;
        }
        mbar_wait(&s.k_full[st], parity);
        wgmma_fence();
        start_qk<DIM>(sc, q_desc, tile_desc(s.k[st]));
        wgmma_commit();
        if (pend >= 0) {
          start_pv(pv, p, tile_desc(s.v[pend]));
          wgmma_commit();
          wgmma_wait<1>();  // Q K_j^T done; P V may still run
        } else {
          wgmma_wait<0>();
        }
        hold(sc);
        const int k0 = ki * kBlock;
        float alpha[2];
        if (k0 + kBlock > seg.Tk ||
            (seg.causal && k0 + kBlock - 1 > q0w + seg.offset))
          softmax_tile<true>(sc, m, l, alpha, seg, r0, k0, c0, scale);
        else
          softmax_tile<false>(sc, m, l, alpha, seg, r0, k0, c0, scale);
        if (pend >= 0) {
          wgmma_wait<0>();
          hold_pv();
          accumulate(acc, pv, pend_alpha);
          mbar_arrive(&s.empty[pend]);
        }
        // P rounded to bf16 straight into the A fragments of P V: the k16
        // slice kk is accumulator columns 16 kk.. (elements 8 kk.. 8 kk +
        // 7), which is the m64k16 A layout, register for register
#pragma unroll
        for (int j = 0; j < 16; ++j)
          p[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
        pend_alpha[0] = alpha[0];
        pend_alpha[1] = alpha[1];
        mbar_wait(&s.v_full[st], parity);
        pend = st;
      }
    }
    // every Q K^T of this tile is done: the producer may load the next Q
    mbar_arrive(&s.q_empty);
    drain();

    // out = acc / max(l, 1e-30) in bf16, lse = m + log(max(l, 1e-30))
    const int bh = tile.b * H + tile.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= Tq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      bf16* dst = out + ((static_cast<size_t>(tile.b) * Tq + row) * H +
                         tile.h) * DIM + c0;
#pragma unroll
      for (int half = 0; half < kHalves; ++half)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 64 * half + 8 * j) =
              __floats2bfloat162_rn(
                  __fdiv_rn(acc[half][4 * j + 2 * r], denom),
                  __fdiv_rn(acc[half][4 * j + 2 * r + 1], denom));
      if ((lane & 3) == 0)
        lse[static_cast<size_t>(bh) * Tq + row] =
            __fadd_rn(m[r], logf(denom));
    }
  }
}

// ---------------------------------------------------------------------
// The bf16 backward's pair step, shared by the three bf16 backward
// kernels of flash_attention.cu (`flash_bwd_hopper_kernel`).
// ---------------------------------------------------------------------

// Key k_pos is hidden from query q_pos where k_pos >= Tk or, under
// causal, q_pos + offset < k_pos.
struct BwdMask {
  int Tk, offset, causal;
};

// the 128 threads of consumer warpgroup `wg` (named barrier 1 + wg; 0 is
// __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Until *count >= target, read with acquire semantics at the device
// scope. One PTX block, like `mbar_wait`; a count that never arrives is
// a bug of the kernel and traps after ~10 s of clock.
__device__ __forceinline__ void wait_count(const unsigned* count,
                                           unsigned target) {
  asm volatile(
      "{\n.reg .pred p, late;\n.reg .u32 v;\n.reg .s64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "LAB_POLL:\n"
      "ld.acquire.gpu.global.u32 v, [%0];\n"
      "setp.ge.u32 p, v, %1;\n"
      "@p bra LAB_READY;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.s64 t1, t1, t0;\n"
      "setp.gt.s64 late, t1, 20000000000;\n"
      "@late trap;\n"
      "bra LAB_POLL;\n"
      "LAB_READY:\n}\n" ::"l"(count),
      "r"(target)
      : "memory");
}

// *count = value with release semantics at the device scope, by the one
// thread whose `leader` is non-zero (a predicate, not a branch)
__device__ __forceinline__ void publish_count(unsigned* count,
                                              unsigned value, int leader) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p st.release.gpu.global.u32 [%0], %1;\n}\n" ::"l"(count),
      "r"(value), "r"(leader)
      : "memory");
}

// One (64-key, 64-query) pair of the backward at head_dim DIM, with the
// keys as wgmma's M: S^T = K Q^T and dP^T = V dO^T as DIM / 16 wgmma each
// (all four operands K-major TMA tiles), then in the accumulator layout
// (element i at key k0 + r0 + 8 ((i >> 1) & 1), query q0 + 8 (i >> 2) +
// c0 + (i & 1)): P^T = the guarded exp(S^T scale - lse), NEG_INF where
// EDGE hides the key, and dS^T = P^T (dP^T - D) scale, both in f32 with
// non-contracted arithmetic, as `_flash_dkv_kernel` computes P and dS. lse
// and D are per query, i.e. per column, read from `stats` (lse at
// [0..63], D at [64..127]; past Tq the producer wrote NEG_INF and 0, so
// those columns get P = 0). Returns P^T and dS^T rounded to bf16 as A
// fragments of the products that contract over the queries (dV += P^T dO,
// dK += dS^T Q: the accumulator layout is the m64k16 A layout register for
// register). With STAGE, dS^T also goes to `ds_tile` (swizzled like a TMA
// tile, keys as rows) for dQ = dS K, which reads it as an MN-major A
// operand; the warpgroup is synchronized before returning. `meanwhile()`
// runs while S^T and dP^T are on the tensor cores.
template <int DIM, bool EDGE, bool STAGE, typename Meanwhile>
__device__ __forceinline__ void backward_pair(
    uint64_t k_desc, uint64_t v_desc, uint64_t q_desc, uint64_t do_desc,
    const float* stats, bf16* ds_tile, int wg, int k0, int q0,
    const BwdMask& mask, float scale, uint32_t (&p)[16], uint32_t (&ds)[16],
    Meanwhile meanwhile) {
  const int t = threadIdx.x & 127, lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
  float s[32], dp[32];
  wgmma_fence();
  start_qk<DIM>(s, k_desc, q_desc);
  wgmma_commit();
  start_qk<DIM>(dp, v_desc, do_desc);
  wgmma_commit();
  meanwhile();
  // this thread's 16 queries: column 8 j + c0 + e is entry 2 j + e. A
  // query whose lse is <= NEG_INF/2 subtracts +inf instead, so that its
  // P is exactly 0, as the guard's select would make it. D is read while
  // the products run at 64, after them at 128, where the dK and dV
  // accumulators hold twice the registers.
  float lse[16], delta[16];
  const auto read_delta = [&] {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d =
          *reinterpret_cast<const float2*>(stats + kBlock + 8 * j + c0);
      delta[2 * j] = d.x;
      delta[2 * j + 1] = d.y;
    }
  };
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(stats + 8 * j + c0);
    lse[2 * j] = l.x > kNegInf * 0.5f ? l.x : __int_as_float(0x7f800000);
    lse[2 * j + 1] = l.y > kNegInf * 0.5f ? l.y : __int_as_float(0x7f800000);
  }
  if constexpr (DIM == 64) read_delta();
  wgmma_wait<1>();
  hold(s);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    bool shown = true;
    if (EDGE) {
      const int key = k0 + r0 + 8 * ((i >> 1) & 1);
      const int query = q0 + 8 * (i >> 2) + c0 + (i & 1);
      shown = key < mask.Tk && (!mask.causal || query + mask.offset >= key);
    }
    const float score = shown ? __fmul_rn(s[i], scale) : kNegInf;
    s[i] = expf(__fsub_rn(score, lse[2 * (i >> 2) + (i & 1)]));
  }
  wgmma_wait<0>();
  hold(dp);
  if constexpr (DIM != 64) read_delta();
#pragma unroll
  for (int i = 0; i < 32; ++i)
    dp[i] = __fmul_rn(
        __fmul_rn(s[i], __fsub_rn(dp[i], delta[2 * (i >> 2) + (i & 1)])),
        scale);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
    ds[j] = pack_bf16(dp[2 * j], dp[2 * j + 1]);
  }
  if (STAGE) {
    // register j holds row r0 + 8 (j & 1), columns 8 (j >> 1) + c0, +1:
    // 16-byte chunk j >> 1 of a 128-byte row, XOR-swizzled by row % 8
    unsigned char* base = reinterpret_cast<unsigned char*>(ds_tile);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int row = r0 + 8 * (j & 1);
      *reinterpret_cast<uint32_t*>(
          base + row * 128 + ((((j >> 1) ^ row) & 7) << 4) + 2 * c0) = ds[j];
    }
    fence_async_smem();
    warpgroup_sync(wg);
  }
}

// dV += P^T dO and dK += dS^T Q, in place: four wgmma for each 64-column
// box of dO and Q, P^T and dS^T from registers, dO and Q MN-major; started,
// not waited
template <int HALVES>
__device__ __forceinline__ void start_dkv(float (&dv)[HALVES][32],
                                          float (&dk)[HALVES][32],
                                          const uint32_t (&p)[16],
                                          const uint32_t (&ds)[16],
                                          uint64_t do_desc,
                                          uint64_t q_desc) {
#pragma unroll
  for (int half = 0; half < HALVES; ++half)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dv[half], p + 4 * kk,
               do_desc + half * kBoxStep + kk * kMNMajorStep, 1);
#pragma unroll
  for (int half = 0; half < HALVES; ++half)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dk[half], ds + 4 * kk,
               q_desc + half * kBoxStep + kk * kMNMajorStep, 1);
}

// The dQ block product dS K of one pair over one 64-column box of K
// (`k_desc` that box), from zero: dS^T staged by `backward_pair` and K,
// both MN-major; started, not waited
__device__ __forceinline__ void start_dq(float (&dq)[32], uint64_t ds_desc,
                                         uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<1, 1>(dq, ds_desc + kk * kMNMajorStep,
                   k_desc + kk * kMNMajorStep, kk);
}

// ---- host: tensor maps ------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime's entry-point
// lookup so that the library links against nothing beyond the CUDA
// runtime; null where it is missing.
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Blocks of a persistent launch over `tiles` work tiles: one an SM of the
// current device (kSmemBytes and the registers hold an SM to one).
inline int persistent_blocks(int tiles) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess || sms < 1)
    sms = 1;
  return tiles < sms ? tiles : sms;
}

// The tensor map of a contiguous [B, T, H, DIM] bf16 tensor at `base`
// (16-byte aligned) in 64x64 boxes, 64 rows of T at one (b, h) and 64
// columns from a multiple of 64, with the 128-byte swizzle; rows past T
// read as zeros. Returns 0, or kTensorMapError + the CUresult of
// cuTensorMapEncodeTiled.
template <int DIM>
inline int encode_rows(CUtensorMap* map, const void* base, int B, int T,
                       int H) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t row = DIM * sizeof(bf16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DIM),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {row, row * H, row * H * T};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(kBlock), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

}  // namespace hopper

}  // namespace
