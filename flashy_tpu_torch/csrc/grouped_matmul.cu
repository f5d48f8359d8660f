// Grouped matrix products on Hopper (sm_90a): the dropless MoE layer's
// expert projections, forward and backward.
//
// Replaces the two Pallas TPU kernels of megablox (installed JAX,
// jax/experimental/pallas/ops/tpu/megablox/gmm.py), which the JAX package
// reaches from flashy_tpu/parallel/moe_ep.py `_grouped_mlp` and through
// the custom VJP of megablox/ops.py (`_gmm_bwd`):
//   * flashy_gmm   <- `gmm` (pallas_call at gmm.py:526): out[rows of g] =
//     lhs[rows of g] . rhs[g], lhs [M, K], rhs [E, K, N], out [M, N];
//   * flashy_gmm_t <- `gmm` with transpose_rhs=True: rhs [E, N, K], out
//     [rows of g] = lhs[rows of g] . rhs[g]^T (the input gradient);
//   * flashy_tgmm  <- `tgmm` (pallas_call at gmm.py:763): out[g] =
//     lhs[rows of g]^T . rhs[rows of g], lhs [M, K], rhs [M, N], out
//     [E, K, N] (the weight gradient). lhs is read as it lies, [M, K],
//     and contracted over its rows: no transposed copy is made.
// Group g owns rows [offset_g, offset_g + group_sizes[g]) (prefix sums in
// group order, clamped to M). Rows of gmm past the last group come out
// as zeros; a tgmm group with no rows gives exact zeros, as megablox's
// `_zero_uninitialized_memory` and its empty-group visits ensure. The
// group sizes stay on the device: every block reads them itself.
//
// What each computes is what the Pallas bodies compute: an f32
// accumulator per output tile over the whole contraction, cast to the
// output dtype once at the end. Types follow megablox's
// `select_input_dtype`: two bf16 operands multiply as bf16 (exact in f32,
// f32 sums); any f32 operand makes the product f32. A bf16 x f32 product
// (the second projection's backward: megablox's f32 dY against a bf16
// weight or activation) runs on the tensor cores as three bf16 products:
// `flashy_split_bf16` writes the f32 operand as planes hi = bf16(x), mid
// = bf16(x - hi), lo = bf16(x - hi - mid), each subtraction exact, so
// that hi + mid + lo == x for every normal f32 with 2^-110 <= |x| <
// bf16's overflow threshold (~3.39e38); each plane times a bf16 value is
// exact in f32, so the three products summed are the f32 product, its
// sums in another order. f32 x f32 alone keeps scalar FMAs in ascending
// contraction order (no TF32).
//
// The tensor-core route (`grouped_wgmma_kernel`, every bf16 x bf16 and
// bf16 x planes launch): a persistent grid, one 384-thread block an SM,
// walks a static schedule of output tiles of 128 rows x kTileN columns.
// gmm / gmm_t: a tile is a (visit, n-tile) pair with the n-tiles fastest,
// so blocks running together share one group's weight in L2; a visit is a
// (group, 128-row tile) pair in group order (`find_visit`; a tile that
// straddles a group edge is visited once by each group, and the rows
// [sum, M) once as group -1, written as zeros). tgmm: a tile is a (group,
// 128-row block of out[g], n-tile) triple, groups slowest. A producer
// warp's one thread issues TMA loads (cp.async.bulk.tensor, 128-byte
// swizzle, zero fill past every edge of the tensor) of 64-deep stages
// into a kWgStages-deep ring guarded by mbarrier full/empty pairs; two
// consumer warpgroups, 64 output rows each, run wgmma.m64nNk16 on the
// stages as they land, both operands read from shared memory through
// descriptors (the transpose bits select K- or MN-major, so no copy of
// any operand is made):
//   gmm    A = lhs rows, K-major;          B = rhs[g] [K, N], MN-major;
//   gmm_t  A = lhs rows, K-major;          B = rhs[g] [N, K], K-major;
//   tgmm   A = lhs^T (rows contracted), MN-major; B = rhs rows, MN-major.
// The weights are 4-D tensor maps [planes, E, K, N] (or [.., N, K]) with
// the group as a coordinate, so a box never reads another group's
// weight. With an operand in planes the contraction runs over the planes
// too (lo first, hi last). Group edges: gmm and gmm_t load the whole
// 128-row box of lhs; rows of another group enter only output rows that
// the visit does not store (megablox's `_get_store_mask`): a visit's
// epilogue stores rows [lo, hi) only. tgmm starts each group's
// contraction at its first row (a TMA coordinate need not be
// tile-aligned); in the last
// stage of a group the rows past its end (the next group's, or zeros past
// M) are cleared in shared memory in both operands by the consumers
// before wgmma reads them (then fence.proxy.async), so a value of another
// group never enters, not even as 0 x inf. The epilogue writes the f32
// accumulators (rounded to bf16 where the output is) into 64-row x
// 128-byte swizzled boxes in shared memory, kOutBoxes a warpgroup in
// turn, and TMA stores them, clipped at the tensor's edges, while the
// next tile's products run; a gmm visit that stores only some of its
// 128 rows (a group edge, the rows past the groups) stores from
// registers, row by row.
//
// What bounds it on this card: operations. At the training shapes (32768
// routed rows, dim 1024, hidden 4096, 8 experts) a launch is 275 GFLOP
// against well under 1 GB: 0.278 ms at the 989 TFLOP/s bf16 peak; a
// split launch three times that (0.834 ms) against 4.10 ms at the 67
// TFLOP/s f32 peak it had as FMAs. Budget: 384 threads under
// __launch_bounds__(384, 1), setmaxnreg 40 for the producer warpgroup and
// 232 for the consumers (the 64 x kTileN f32 accumulator is kTileN / 2
// registers a thread); shared memory kWgStages x 48 KB of stages and 2 x
// kOutBoxes x 8 KB of output boxes. No branch around
// a wgmma may look divergent to ptxas, or it serializes every wgmma
// (C7520): the warpgroup index and every tile value read from memory are
// broadcast with __shfl_sync, and the barrier spins are one PTX block
// (`hopper::mbar_wait`), and the final wait on the products comes on
// every path before the accumulator is read (a path without one gets a
// wait injected and every wgmma serialized, C7517/C7518). Times beside
// the bounds, and the design rounds that chose kTileN, kWgStages,
// kOutBoxes and the planes' order, are in PERF.md.
#include "flash_tile.cuh"  // namespace hopper: mbarriers, wgmma, tensor maps

namespace {
namespace gmm {

using bf16 = __nv_bfloat16;

enum Layout { kNN = 0, kNT = 1, kTN = 2 };

constexpr int kBM = 128;  // output tile rows, both routes

// ---------------------------------------------------------------------
// which rows a tile owns
// ---------------------------------------------------------------------

// gmm / gmm_t: visit v -> (group, tile). A non-empty group visits every
// kBM-row tile its rows touch, in group order; after the groups, the
// rows [total, M) are visited as group -1 (written as zeros). Returns
// false past the last visit.
__device__ bool find_visit(const int* sizes, int E, int M, int v, int* group,
                           int* row0, int* lo, int* hi) {
  long long start = 0;
  int seen = 0;
  for (int g = 0; g <= E; ++g) {
    const long long end =
        g < E ? min(start + max(sizes[g], 0), static_cast<long long>(M))
              : static_cast<long long>(M);
    if (end > start) {
      const int first = static_cast<int>(start / kBM);
      const int count = static_cast<int>((end - 1) / kBM) - first + 1;
      if (v < seen + count) {
        *group = g < E ? g : -1;
        *row0 = (first + v - seen) * kBM;
        *lo = max(static_cast<int>(start), *row0);
        *hi = min(static_cast<int>(end), *row0 + kBM);
        return true;
      }
      seen += count;
    }
    start = end;
  }
  return false;
}

// tgmm: the rows [lo, hi) of group g
__device__ void group_rows(const int* sizes, int g, int M, int* lo, int* hi) {
  long long start = 0;
  for (int i = 0; i < g; ++i) start += max(sizes[i], 0);
  start = min(start, static_cast<long long>(M));
  *lo = static_cast<int>(start);
  *hi = static_cast<int>(
      min(start + max(sizes[g], 0), static_cast<long long>(M)));
}

// ---------------------------------------------------------------------
// the f32 operand as three bf16 planes
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x [n4 float4s] -> planes [3][n4] of four bf16 each: hi, mid, lo
__global__ void split_bf16_kernel(const float4* __restrict__ x,
                                  uint2* __restrict__ planes, long long n4) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += step) {
    const float4 v = x[i];
    const float in[4] = {v.x, v.y, v.z, v.w};
    bf16 h[4], m[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = __float2bfloat16_rn(in[e]);
      const float r = __fsub_rn(in[e], __bfloat162float(h[e]));
      m[e] = __float2bfloat16_rn(r);
      l[e] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(m[e])));
    }
    planes[i] = make_uint2(pack2(h[0], h[1]), pack2(h[2], h[3]));
    planes[n4 + i] = make_uint2(pack2(m[0], m[1]), pack2(m[2], m[3]));
    planes[2 * n4 + i] = make_uint2(pack2(l[0], l[1]), pack2(l[2], l[3]));
  }
}

// ---------------------------------------------------------------------
// tensor-core route: wgmma on TMA stages, a persistent grid
// ---------------------------------------------------------------------

// Compile-time choices, measured on the H100 at the training shapes (root
// PERF.md, Findings).
constexpr int kTileN = 256;    // output tile columns (wgmma N: 128 or 256)
constexpr int kTileK = 64;     // contraction depth of a stage
constexpr int kWgStages = 4;   // stages in flight
constexpr int kOutBoxes = 2;   // output boxes in flight a warpgroup
constexpr int kConsumers = 2;  // consumer warpgroups, 64 rows each
constexpr int kWgThreads = 128 * (kConsumers + 1);  // + the producer's
// at launch 65536 / 384 -> 168 a thread; setmaxnreg moves them
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <=
                  65536,
              "the warpgroups' registers must fit one SM");
static_assert(kTileN == 128 || kTileN == 256, "wgmma N of 128 or 256");
constexpr int kBox = 64 * kTileK;  // elements of a 64 x 64 box (8 KB)
constexpr uint32_t kStageBytes = (kBM + kTileN) * kTileK * sizeof(bf16);

// Every box 1024-byte aligned (the 128-byte swizzle's period). A stage's
// A holds 128 rows (gmm, gmm_t: one box of 128 lhs rows, K-major; tgmm:
// two 64 x 64 boxes, one per warpgroup, MN-major); its B kTileN columns
// (gmm_t: one box of kTileN weight rows, K-major; gmm, tgmm: kTileN / 64
// boxes of 64 columns, MN-major).
struct alignas(1024) WgSmem {
  bf16 a[kWgStages][kBM * kTileK];
  bf16 b[kWgStages][kTileN * kTileK];
  // the epilogue's output boxes a warpgroup: 64 rows x 128 bytes
  unsigned char out[kConsumers][kOutBoxes][64 * 128];
  uint64_t full[kWgStages], empty[kWgStages];
};
constexpr size_t kWgSmemBytes = sizeof(WgSmem) + 1024;  // + alignment
static_assert(kWgSmemBytes <= 232448, "a block's shared memory");

struct WgArgs {
  const int* sizes;  // [E] int32 group sizes, on the device
  void* out;
  int M, K, N, E;
  int out_bf16;
  int a_planes, b_planes;  // 1, or 3 for an operand split into planes
};

// One output tile. gmm / gmm_t: rows [m0, m0 + kBM) of a visit of group
// `group` (-1: rows past the groups), stored where in [lo, hi). tgmm: rows
// [m0, m0 + kBM) of out[group], contracting the group's rows [lo, hi).
// `ksteps` is the kTileK-deep steps of a plane (0: the tile is zeros).
struct WgTile {
  int group, m0, lo, hi, n0, ksteps;
};

template <int L>
__device__ __forceinline__ bool wg_tile(const WgArgs& a, int i, WgTile* t) {
  const int tiles_n = (a.N + kTileN - 1) / kTileN;
  if constexpr (L == kTN) {
    const int per_group = ((a.K + kBM - 1) / kBM) * tiles_n;
    const int g = i / per_group, rest = i % per_group;
    if (g >= a.E) return false;
    t->group = g;
    t->m0 = rest / tiles_n * kBM;
    t->n0 = rest % tiles_n * kTileN;
    group_rows(a.sizes, g, a.M, &t->lo, &t->hi);
    t->ksteps = (t->hi - t->lo + kTileK - 1) / kTileK;
  } else {
    if (!find_visit(a.sizes, a.E, a.M, i / tiles_n, &t->group, &t->m0,
                    &t->lo, &t->hi))
      return false;
    t->n0 = i % tiles_n * kTileN;
    t->ksteps = t->group < 0 ? 0 : (a.K + kTileK - 1) / kTileK;
  }
  return true;
}

// lane 0's value in every lane: the compiler then knows each branch on it
// to be warp-uniform (wgmma behind a branch it cannot prove uniform is
// serialized)
__device__ __forceinline__ int uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

__device__ __forceinline__ void tma3(void* dst, const CUtensorMap* map,
                                     uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(hopper::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma4(void* dst, const CUtensorMap* map,
                                     uint64_t* bar, int c0, int c1, int c2,
                                     int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          hopper::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(hopper::smem_u32(bar))
      : "memory");
}

// The stage of k-step k0.. of tile t, plane pa of A and pb of B, into
// stage `st`; completes on full[st].
template <int L>
__device__ __forceinline__ void load_stage(WgSmem& s, int st,
                                           const CUtensorMap* a_map,
                                           const CUtensorMap* b_map,
                                           const WgTile& t, int k0, int pa,
                                           int pb) {
  uint64_t* bar = &s.full[st];
  if constexpr (L == kTN) {
    // lhs [planes, M, K]: 64 columns (out rows) x 64 rows (contraction)
#pragma unroll
    for (int w = 0; w < 2; ++w)
      tma3(s.a[st] + w * kBox, a_map, bar, t.m0 + 64 * w, t.lo + k0, pa);
    // rhs [planes, M, N]
#pragma unroll
    for (int j = 0; j < kTileN / 64; ++j)
      tma3(s.b[st] + j * kBox, b_map, bar, t.n0 + 64 * j, t.lo + k0, pb);
  } else {
    // lhs [planes, M, K]: 64 columns x 128 rows
    tma3(s.a[st], a_map, bar, k0, t.m0, pa);
    if constexpr (L == kNN) {
      // rhs [planes, E, K, N]: 64 columns x 64 rows of rhs[g]
#pragma unroll
      for (int j = 0; j < kTileN / 64; ++j)
        tma4(s.b[st] + j * kBox, b_map, bar, t.n0 + 64 * j, k0, t.group, pb);
    } else {
      // rhs [planes, E, N, K]: 64 columns x kTileN rows of rhs[g]
      tma4(s.b[st], b_map, bar, k0, t.n0, t.group, pb);
    }
  }
}

// wgmma descriptor of a 128-byte-swizzled tile as TMA wrote it: 8-row
// groups 1024 bytes apart (the SBO: along M/N for a K-major operand,
// along K for an MN-major one); `lbo`, read by an MN-major operand wider
// than one 64-column swizzle atom, is the stride from one 64-column box
// to the next.
__device__ __forceinline__ uint64_t desc(const bf16* tile, uint32_t lbo) {
  return static_cast<uint64_t>((hopper::smem_u32(tile) & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (uint64_t{1} << 62);
}
// descriptor offsets (16-byte units) of the k-th 16-deep slice: 32 bytes
// along a K-major row, 16 rows of 128 bytes down an MN-major box
constexpr uint64_t kKMajorStep = 32 >> 4, kMNMajorStep = 2048 >> 4;

// d (+)= A B, m64nNk16 with N = kTileN, A and B in shared memory; TA / TB
// 1 for an MN-major operand
template <int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[kTileN / 2], uint64_t a,
                                           uint64_t b, int accumulate) {
  if constexpr (kTileN == 256) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104,"
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115,"
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126,"
      "%127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  } else {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
}

// keeps the compiler from moving reads of the accumulator across a wait
__device__ __forceinline__ void hold(float (&r)[kTileN / 2]) {
#pragma unroll
  for (int i = 0; i < kTileN / 2; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// tgmm: rows [valid, 64) of every 64-row box of stage `st` (A's two and
// B's kTileN / 64) to zero, by the 256 consumer threads (thread `t`),
// made visible to wgmma (async proxy) and waited for by both warpgroups
__device__ __forceinline__ void clear_tail(WgSmem& s, int st, int valid,
                                           int t) {
  constexpr int kBoxes = 2 + kTileN / 64;
  const int per_box = (kTileK - valid) * 8;  // 16-byte chunks a box
  for (int c = t; c < kBoxes * per_box; c += 128 * kConsumers) {
    const int box = c / per_box, at = c % per_box;
    bf16* base = box < 2 ? s.a[st] + box * kBox : s.b[st] + (box - 2) * kBox;
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(base) +
                              (valid + at / 8) * 128 + (at % 8) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  hopper::fence_async_smem();
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

// rows of warpgroup wg's 64 x kTileN accumulator into the output: element
// i at row r0 + 8 ((i >> 1) & 1), column 8 (i >> 2) + c0 + (i & 1); gmm
// stores rows [lo, hi), tgmm rows below K of out[group]; columns below N
template <int L>
__device__ __forceinline__ void store_tile(const WgArgs& a, const WgTile& t,
                                           int wg,
                                           const float (&acc)[kTileN / 2]) {
  const int lane = threadIdx.x & 31;
  const int r0 = t.m0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int c0 = t.n0 + 2 * (lane & 3);
  const int row_lo = L == kTN ? 0 : t.lo;
  const int row_hi = L == kTN ? a.K : t.hi;
  const long long base = L == kTN ? static_cast<long long>(t.group) * a.K : 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row < row_lo || row >= row_hi) continue;
    const long long at = (base + row) * a.N;
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
      const int col = c0 + 8 * j;
      if (col >= a.N) continue;
      const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if (a.out_bf16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + at +
                                           col) = __floats2bfloat162_rn(x, y);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at + col) =
            make_float2(x, y);
    }
  }
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3}], [%4];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(hopper::smem_u32(src))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup wg (named barrier 2 + wg; 0 is
// __syncthreads', 1 `clear_tail`'s)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// Warpgroup wg's 64 x kTileN accumulator into rows m0 + 64 wg.. of the
// output through shared memory and TMA stores (tensor map `o_map` over
// [groups, rows, N]; rows and columns past the tensor are not written),
// 64-row x 128-byte boxes (32 f32 or 64 bf16 columns) in the 128-byte
// swizzle, kOutBoxes buffers a warpgroup taken in turn over the whole
// launch (`boxes` counts the warpgroup's boxes): a box is written while
// the stores of the ones before are in flight, and the last stores drain
// while the next tile's products run. Thread 0 of the warpgroup issues
// the stores.
template <bool BF16>
__device__ __forceinline__ void store_tile_tma(WgSmem& s,
                                               const CUtensorMap* o_map,
                                               const WgTile& t, int wg,
                                               int layer,
                                               const float (&acc)[kTileN / 2],
                                               int& boxes) {
  constexpr int kCols = BF16 ? 64 : 32;  // columns of a 128-byte box row
  constexpr int kBlocks = kCols / 8;     // accumulator 8-column blocks
  const int tid = threadIdx.x & 127, lane = tid & 31;
  const bool leader = tid == 0;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);  // box row of acc rows
  const int q4 = lane & 3;
#pragma unroll
  for (int q = 0; q < kTileN / kCols; ++q, ++boxes) {
    unsigned char* box = s.out[wg][boxes % kOutBoxes];
    // the store that read this buffer kOutBoxes boxes ago is done reading
    if (leader)
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kOutBoxes - 1)
                   : "memory");
    warpgroup_sync(wg);
#pragma unroll
    for (int jj = 0; jj < kBlocks; ++jj) {
      const int j = q * kBlocks + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
        if (BF16) {
          // 16-byte chunk jj of the row, 4 bytes a lane
          *reinterpret_cast<__nv_bfloat162*>(
              box + row * 128 + (((jj ^ row) & 7) << 4) + 4 * q4) =
              __floats2bfloat162_rn(x, y);
        } else {
          // 16-byte chunk 2 jj + q4 / 2, 8 bytes a lane
          *reinterpret_cast<float2*>(
              box + row * 128 + ((((2 * jj + (q4 >> 1)) ^ row) & 7) << 4) +
              8 * (q4 & 1)) = make_float2(x, y);
        }
      }
    }
    hopper::fence_async_smem();
    warpgroup_sync(wg);
    if (leader)
      tma_store(o_map, box, t.n0 + q * kCols, t.m0 + 64 * wg, layer);
  }
}

template <int L>
__global__ void __launch_bounds__(kWgThreads, 1)
    grouped_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                         const __grid_constant__ CUtensorMap b_map,
                         const __grid_constant__ CUtensorMap o_map,
                         const WgArgs a) {
  extern __shared__ unsigned char wg_smem[];
  WgSmem& s = *reinterpret_cast<WgSmem*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t{1023});
  const int wg = uniform(threadIdx.x / 128);
  const int planes = a.a_planes > a.b_planes ? a.a_planes : a.b_planes;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      hopper::mbar_init(&s.full[i], 1);
      hopper::mbar_init(&s.empty[i], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step s of a tile with k steps a plane: (k-step, plane), the planes
  // one after the other, lo (2) first and hi (0) last. The small planes'
  // sums then build up in a small accumulator: the tensor cores' f32
  // accumulation drops low bits at each k16 step, and with the planes
  // interleaved per k-step every step adds into the full-size sum (that
  // missed the 1e-5 bar at K = 4096; root PERF.md, Findings).
  const auto step_at = [&](int step, int ksteps, int* ks, int* plane) {
    *ks = step % ksteps;
    *plane = planes - 1 - step / ksteps;
  };

  if (wg == kConsumers) {
    // producer: one thread starts every load; `it` counts stages over the
    // whole launch
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x != 128 * kConsumers) return;
    int it = 0;
    for (int i = blockIdx.x;; i += gridDim.x) {
      WgTile t;
      if (!wg_tile<L>(a, i, &t)) break;
      for (int step = 0; step < t.ksteps * planes; ++step, ++it) {
        const int st = it % kWgStages;
        int ks, plane;
        step_at(step, t.ksteps, &ks, &plane);
        hopper::mbar_wait(&s.empty[st], ((it / kWgStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&s.full[st], kStageBytes);
        load_stage<L>(s, st, &a_map, &b_map, t, ks * kTileK,
                      a.a_planes > 1 ? plane : 0,
                      a.b_planes > 1 ? plane : 0);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of every tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));
  constexpr int kTA = L == kTN, kTB = L != kNT;
  constexpr uint64_t kAStep = kTA ? kMNMajorStep : kKMajorStep;
  constexpr uint64_t kBStep = kTB ? kMNMajorStep : kKMajorStep;
  float acc[kTileN / 2];
  int it = 0, boxes = 0;
  for (int i = blockIdx.x;; i += gridDim.x) {
    WgTile t;
    const int more = wg_tile<L>(a, i, &t);
    if (!uniform(more)) break;
    t.group = uniform(t.group);
    t.m0 = uniform(t.m0);
    t.lo = uniform(t.lo);
    t.hi = uniform(t.hi);
    t.n0 = uniform(t.n0);
    t.ksteps = uniform(t.ksteps);
    const int steps = t.ksteps * planes;
    for (int step = 0; step < steps; ++step, ++it) {
      const int st = it % kWgStages;
      hopper::mbar_wait(&s.full[st], (it / kWgStages) & 1);
      if (L == kTN) {
        int ks, plane;
        step_at(step, t.ksteps, &ks, &plane);
        const int valid = t.hi - t.lo - ks * kTileK;
        if (valid < kTileK) clear_tail(s, st, valid, threadIdx.x);
      }
      const uint64_t ad = desc(s.a[st] + wg * kBox, 64 * kTileK * 2);
      const uint64_t bd = desc(s.b[st], 64 * kTileK * 2);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk)
        wgmma_tile<kTA, kTB>(acc, ad + kk * kAStep, bd + kk * kBStep,
                             step > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous stage's products are done
      if (step > 0) hopper::mbar_arrive(&s.empty[(it - 1) % kWgStages]);
    }
    // on every path, so that ptxas sees each use of the accumulator after
    // a wait (a path without one gets a wait injected and every wgmma
    // serialized, C7517/C7518)
    hopper::wgmma_wait<0>();
    if (steps > 0) hopper::mbar_arrive(&s.empty[(it - 1) % kWgStages]);
    hold(acc);
    if (steps == 0) {
#pragma unroll
      for (int j = 0; j < kTileN / 2; ++j) acc[j] = 0.f;
    }
    // tgmm tiles and gmm tiles that store all their 128 rows go through
    // TMA (it clips rows and columns past the tensor, not rows of another
    // visit): the others store from registers
    if (L == kTN || (t.lo == t.m0 && t.hi == t.m0 + kBM)) {
      const int layer = L == kTN ? t.group : 0;
      if (a.out_bf16)
        store_tile_tma<true>(s, &o_map, t, wg, layer, acc, boxes);
      else
        store_tile_tma<false>(s, &o_map, t, wg, layer, acc, boxes);
    } else {
      store_tile<L>(a, t, wg, acc);
    }
  }
  // every output store done before the block's shared memory goes
  if ((threadIdx.x & 127) == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The tensor map of a contiguous bf16 (or, with `f32`, f32) tensor of
// `rank` dimensions (dims[0] the innermost) at `base`, boxes `box`, the
// 128-byte swizzle, zeros read past every edge and nothing stored past
// one. Returns 0, or hopper::kTensorMapError + the CUresult.
int encode(CUtensorMap* map, const void* base, int rank,
           const cuuint64_t* dims, const cuuint32_t* box, int f32 = 0) {
  const hopper::EncodeTiled encode_tiled = hopper::tensor_map_encoder();
  if (encode_tiled == nullptr)
    return hopper::kTensorMapError + CUDA_ERROR_NOT_FOUND;
  cuuint64_t strides[4];
  cuuint64_t stride = f32 ? sizeof(float) : sizeof(bf16);
  for (int i = 0; i + 1 < rank; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode_tiled(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      rank, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : hopper::kTensorMapError + static_cast<int>(r);
}

// a cudaError_t, or hopper::kTensorMapError + a CUresult
template <int L>
int launch_wgmma(const void* lhs, const void* rhs, const WgArgs& a,
                 cudaStream_t stream) {
  using u64 = cuuint64_t;
  using u32 = cuuint32_t;
  const u64 M = a.M, K = a.K, N = a.N, E = a.E;
  CUtensorMap a_map, b_map;
  int err;
  if (L == kTN) {
    const u64 ad[3] = {K, M, static_cast<u64>(a.a_planes)};
    const u64 bd[3] = {N, M, static_cast<u64>(a.b_planes)};
    const u32 box[3] = {64, kTileK, 1};
    err = encode(&a_map, lhs, 3, ad, box);
    if (err == 0) err = encode(&b_map, rhs, 3, bd, box);
  } else {
    const u64 ad[3] = {K, M, static_cast<u64>(a.a_planes)};
    const u32 abox[3] = {kTileK, kBM, 1};
    err = encode(&a_map, lhs, 3, ad, abox);
    const u64 bp = a.b_planes;
    const u64 bd_nn[4] = {N, K, E, bp}, bd_nt[4] = {K, N, E, bp};
    const u32 bbox_nn[4] = {64, kTileK, 1, 1};
    const u32 bbox_nt[4] = {kTileK, kTileN, 1, 1};
    if (err == 0)
      err = L == kNN ? encode(&b_map, rhs, 4, bd_nn, bbox_nn)
                     : encode(&b_map, rhs, 4, bd_nt, bbox_nt);
  }
  // the output as [groups, rows, N]: tgmm [E, K, N], gmm [1, M, N]
  CUtensorMap o_map;
  const u64 od[3] = {N, L == kTN ? K : M, L == kTN ? E : 1};
  const u32 obox[3] = {a.out_bf16 ? 64u : 32u, 64, 1};
  if (err == 0) err = encode(&o_map, a.out, 3, od, obox, !a.out_bf16);
  if (err != 0) return err;
  const long long tiles_n = (N + kTileN - 1) / kTileN;
  const long long tiles =
      L == kTN ? static_cast<long long>(E) * ((K + kBM - 1) / kBM) * tiles_n
               : static_cast<long long>((M + kBM - 1) / kBM + E) * tiles_n;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = grouped_wgmma_kernel<L>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWgSmemBytes));
  if (e != cudaSuccess) return e;
  const int blocks = hopper::persistent_blocks(static_cast<int>(tiles));
  kernel<<<blocks, kWgThreads, kWgSmemBytes, stream>>>(a_map, b_map, o_map,
                                                       a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// f32 route: f32 x f32, explicit fmaf in ascending order
// ---------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBN = 128;          // output tile columns
constexpr int kFmaBK = 16;        // contraction depth of an f32 stage
constexpr int kFmaLd = kBM + 4;   // padded f32 tile row (16-byte aligned)

struct Args {
  const void* lhs;
  const void* rhs;
  const int* sizes;   // [E] int32 group sizes, on the device
  void* out;
  int M, K, N, E;
  int out_bf16;
};

// zeros into rows [r_lo, r_hi) x columns [n0, n0 + kBN) of a row-major
// [*, N] output whose row r starts at element (row_base + r) * N
__device__ void store_zeros(void* out, int out_bf16, long long row_base,
                            int r_lo, int r_hi, int n0, int N) {
  constexpr int kQuads = kBN / 4;
  const int rows = r_hi - r_lo;
  for (int i = threadIdx.x; i < rows * kQuads; i += kThreads) {
    const int c = n0 + (i % kQuads) * 4;
    if (c >= N) continue;
    const long long at = (row_base + r_lo + i / kQuads) * N + c;
    if (out_bf16)
      *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + at) =
          make_uint2(0u, 0u);
    else
      *reinterpret_cast<float4*>(static_cast<float*>(out) + at) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// A ROWS x COLS tile of a row-major f32 matrix (leading dimension ld,
// top-left (row0, col0)), read 16 bytes per chunk into registers; rows
// outside [lo, hi) and columns at or past `cols` read as zeros. `put`
// writes it into shared memory as dst[r][c] or, TRANS, dst[c][r].
template <int ROWS, int COLS>
struct Staged {
  static constexpr int kElems = 4;
  static constexpr int kChunks = COLS / kElems;
  static constexpr int kPer = ROWS * kChunks / kThreads;
  static_assert(ROWS * kChunks % kThreads == 0, "tile is not whole chunks");
  uint4 raw[kPer];

  __device__ __forceinline__ void get(const float* src, long long ld,
                                      int row0, int lo, int hi, int col0,
                                      int cols) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int gr = row0 + c / kChunks, gc = col0 + (c % kChunks) * kElems;
      raw[i] = gr >= lo && gr < hi && gc < cols
                   ? *reinterpret_cast<const uint4*>(src + gr * ld + gc)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  template <bool TRANS>
  __device__ __forceinline__ void put(float* dst) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kChunks, cc = (c % kChunks) * kElems;
      const float* v = reinterpret_cast<const float*>(&raw[i]);
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        if constexpr (TRANS)
          dst[(cc + e) * kFmaLd + r] = v[e];
        else
          dst[r * kFmaLd + cc + e] = v[e];
      }
    }
  }
};

template <int L>
__global__ void __launch_bounds__(kThreads)
    grouped_fma_kernel(const Args a) {
  // As[k][m] and Bs[k][n], two stages
  __shared__ __align__(16) float As[2][kFmaBK * kFmaLd];
  __shared__ __align__(16) float Bs[2][kFmaBK * kFmaLd];
  const float* lhs = static_cast<const float*>(a.lhs);
  const float* rhs = static_cast<const float*>(a.rhs);
  const int n0 = blockIdx.x * kBN;

  int group, m0, lo, hi;
  if constexpr (L == kTN) {
    group = blockIdx.z;
    m0 = blockIdx.y * kBM;
    group_rows(a.sizes, group, a.M, &lo, &hi);
    if (hi <= lo) {
      store_zeros(a.out, a.out_bf16, static_cast<long long>(group) * a.K, m0,
                  min(m0 + kBM, a.K), n0, a.N);
      return;
    }
  } else {
    if (!find_visit(a.sizes, a.E, a.M, blockIdx.y, &group, &m0, &lo, &hi))
      return;
    if (group < 0) {
      store_zeros(a.out, a.out_bf16, 0, lo, hi, n0, a.N);
      return;
    }
    rhs += static_cast<long long>(group) * a.K * a.N;
  }
  const int depth = L == kTN ? hi - lo : a.K;
  const int steps = (depth + kFmaBK - 1) / kFmaBK;

  // A (m x k): lhs rows are m (gmm, gmm_t; stored transposed) or the
  // contraction (tgmm; stored as read). B (k x n): rhs[g] is [K, N] (gmm)
  // or [N, K] (gmm_t; stored transposed); tgmm's rhs is [M, N].
  using StageA = Staged<L == kTN ? kFmaBK : kBM, L == kTN ? kBM : kFmaBK>;
  using StageB = Staged<L == kNT ? kBN : kFmaBK, L == kNT ? kFmaBK : kBN>;
  StageA sa;
  StageB sb;
  auto fetch = [&](int step) {
    const int k0 = step * kFmaBK;
    if constexpr (L == kTN) {
      sa.get(lhs, a.K, lo + k0, lo, hi, m0, a.K);
      sb.get(rhs, a.N, lo + k0, lo, hi, n0, a.N);
    } else {
      sa.get(lhs, a.K, m0, lo, hi, k0, a.K);
      if constexpr (L == kNN)
        sb.get(rhs, a.N, k0, 0, a.K, n0, a.N);
      else
        sb.get(rhs, a.K, n0, 0, a.N, k0, a.K);
    }
  };
  auto stash = [&](int stage) {
    sa.template put<L != kTN>(As[stage]);
    sb.template put<L == kNT>(Bs[stage]);
  };

  // thread (ty, tx) owns rows {ty*4 + i, 64 + ty*4 + i} and columns
  // {tx*4 + j, 64 + tx*4 + j}: 16-byte shared reads, no bank conflict
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    if (step + 1 < steps) fetch(step + 1);
    const float* as = As[cur];
    const float* bs = Bs[cur];
#pragma unroll 4
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float x[8], y[8];
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kFmaLd +
                                                         ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kFmaLd +
                                                         64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kFmaLd +
                                                         tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kFmaLd +
                                                         64 + tx * 4);
      x[0] = a0.x; x[1] = a0.y; x[2] = a0.z; x[3] = a0.w;
      x[4] = a1.x; x[5] = a1.y; x[6] = a1.z; x[7] = a1.w;
      y[0] = b0.x; y[1] = b0.y; y[2] = b0.z; y[3] = b0.w;
      y[4] = b1.x; y[5] = b1.y; y[6] = b1.z; y[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    if (step + 1 < steps) stash(cur ^ 1);
    __syncthreads();
  }

  const long long row_base = L == kTN ? static_cast<long long>(group) * a.K
                                      : 0;
  const int row_lo = L == kTN ? 0 : lo;
  const int row_hi = L == kTN ? a.K : hi;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row < row_lo || row >= row_hi) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (col >= a.N) continue;
      const long long at = (row_base + row) * a.N + col;
      const float* v = acc[i] + 4 * h;
      if (a.out_bf16) {
        __nv_bfloat162 lo2 = __floats2bfloat162_rn(v[0], v[1]);
        __nv_bfloat162 hi2 = __floats2bfloat162_rn(v[2], v[3]);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo2);
        packed.y = *reinterpret_cast<uint32_t*>(&hi2);
        *reinterpret_cast<uint2*>(static_cast<bf16*>(a.out) + at) = packed;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + at) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

template <int L>
cudaError_t launch_fma(const Args& a, cudaStream_t s) {
  const long long tiles_n = (a.N + kBN - 1) / kBN;
  const long long rows =
      L == kTN ? (a.K + kBM - 1) / kBM : (a.M + kBM - 1) / kBM + a.E;
  if (tiles_n > 0x7fffffffLL || rows > 65535 || a.E > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles_n), static_cast<unsigned>(rows),
                  L == kTN ? a.E : 1);
  grouped_fma_kernel<L><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// entry
// ---------------------------------------------------------------------

// dtypes: 0 f32, 1 bf16, 2 an f32 operand as bf16 planes [3, ...]. f32 x
// f32 runs the FMA kernel; bf16 or planes on both sides (planes on one
// side at most) the wgmma kernel. Returns a cudaError_t, or
// hopper::kTensorMapError + a CUresult.
int entry(int layout, int lhs_dtype, int rhs_dtype, int out_dtype,
          const void* lhs, const void* rhs, const int* sizes, void* out,
          int M, int K, int N, int E, void* stream) {
  const bool f32 = lhs_dtype == 0 && rhs_dtype == 0;
  const bool tensor = lhs_dtype >= 1 && lhs_dtype <= 2 && rhs_dtype >= 1 &&
                      rhs_dtype <= 2 && lhs_dtype + rhs_dtype <= 3;
  const bool ok = (f32 || (tensor && M >= 1)) && out_dtype >= 0 &&
                  out_dtype <= 1 && M >= 0 && K >= 8 && N >= 8 &&
                  K % 8 == 0 && N % 8 == 0 && E >= 1;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    const Args a{lhs, rhs, sizes, out, M, K, N, E, out_dtype};
    switch (layout) {
      case kNN: return static_cast<int>(launch_fma<kNN>(a, s));
      case kNT: return static_cast<int>(launch_fma<kNT>(a, s));
      default: return static_cast<int>(launch_fma<kTN>(a, s));
    }
  }
  const WgArgs w{sizes, out, M, K, N, E, out_dtype,
                 lhs_dtype == 2 ? 3 : 1, rhs_dtype == 2 ? 3 : 1};
  switch (layout) {
    case kNN: return launch_wgmma<kNN>(lhs, rhs, w, s);
    case kNT: return launch_wgmma<kNT>(lhs, rhs, w, s);
    default: return launch_wgmma<kTN>(lhs, rhs, w, s);
  }
}

}  // namespace gmm
}  // namespace

// dtypes: 0 f32, 1 bf16, 2 an f32 operand written as bf16 planes by
// flashy_split_bf16 ([3, rows, cols] for lhs and tgmm's rhs, [3, E, ...]
// for a weight). K and N multiples of 8 (16-byte rows), pointers 16-byte
// aligned, group_sizes an [E] int32 array on the device; M >= 1 unless
// both operands are f32. Each returns a cudaError_t (0 = launched), or
// for a refused tensor map hopper::kTensorMapError + its CUresult.

// out [M, N] = per group lhs [M, K] . rhs[g] [K, N]
extern "C" int flashy_gmm(int lhs_dtype, int rhs_dtype, int out_dtype,
                          const void* lhs, const void* rhs,
                          const int* group_sizes, void* out, int M, int K,
                          int N, int E, void* stream) {
  return gmm::entry(gmm::kNN, lhs_dtype, rhs_dtype, out_dtype, lhs, rhs,
                    group_sizes, out, M, K, N, E, stream);
}

// out [M, N] = per group lhs [M, K] . rhs[g]^T, rhs [E, N, K]
extern "C" int flashy_gmm_t(int lhs_dtype, int rhs_dtype, int out_dtype,
                            const void* lhs, const void* rhs,
                            const int* group_sizes, void* out, int M, int K,
                            int N, int E, void* stream) {
  return gmm::entry(gmm::kNT, lhs_dtype, rhs_dtype, out_dtype, lhs, rhs,
                    group_sizes, out, M, K, N, E, stream);
}

// out [E, K, N]: out[g] = lhs[rows of g]^T . rhs[rows of g], lhs [M, K],
// rhs [M, N]
extern "C" int flashy_tgmm(int lhs_dtype, int rhs_dtype, int out_dtype,
                           const void* lhs, const void* rhs,
                           const int* group_sizes, void* out, int M, int K,
                           int N, int E, void* stream) {
  return gmm::entry(gmm::kTN, lhs_dtype, rhs_dtype, out_dtype, lhs, rhs,
                    group_sizes, out, M, K, N, E, stream);
}

// planes [3, n] bf16 (hi, mid, lo) of x [n] f32; n a multiple of 4, both
// pointers 16-byte aligned. Returns a cudaError_t.
extern "C" int flashy_split_bf16(const void* x, void* planes, long long n,
                                 void* stream) {
  if (n < 0 || n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long n4 = n / 4;
  const int blocks = static_cast<int>(
      n4 / 256 + 1 < 132LL * 16 ? n4 / 256 + 1 : 132LL * 16);
  gmm::split_bf16_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(
                                               stream)>>>(
      static_cast<const float4*>(x), static_cast<uint2*>(planes), n4);
  return static_cast<int>(cudaGetLastError());
}
