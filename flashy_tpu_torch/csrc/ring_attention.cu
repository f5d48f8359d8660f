// Ring attention in bf16, forward, on Hopper (sm_90a), at head_dim 64 and
// 128 (f32, and bf16 at other head dims, take the flash forward's general
// route over the same table of visible blocks, flash_general.cu).
//
// Replaces the Pallas TPU kernel `_fused_kernel` of
// flashy_tpu/parallel/ring_fused.py (launched by `_fused_forward`): the
// whole ring-attention forward of one rank of an n-rank `seq` ring. Rank r
// holds the query block of global rows [r * T, (r + 1) * T) and computes
// exact softmax attention of those rows over the whole sequence: out in
// q's dtype and the f32 logsumexp, [B, H, T] rows (the layout the port's
// flash kernels and the ring backward read; the TPU kernel broadcast each
// row over 128 lanes).
//
// What it computes, as the TPU kernel does: ring step s visits the K/V
// block of owner (r - s) mod n, in that order, and the flash online
// softmax runs across the steps as if they were one key sequence. Under
// `causal` the steps s > r are the future and are skipped (no loads, no
// products), and step 0, the rank's own block, takes the in-block mask
// q_pos >= k_pos (offset 0: the query and key blocks have the same T).
// Scores are q.k in f32 times `flash_scale` (1/sqrt(D) in f64 rounded to
// f32), a row's max moves only where it beats NEG_INF/2 (the guarded
// exp), P is rounded to V's dtype once per 64-key tile before P.V, and
// out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)). The 64-key
// step is the flash forward's own (`hopper_forward`, flash_tile.cuh), so a
// one-rank ring is bit-equal to the flash forward, and the plain version
// (`parallel/ring_fused.py` `ring_forward_plain`) steps at the same tiles
// in the same order.
//
// What the TPU kernel needed and this one does not: there, the K/V blocks
// travel the ring by in-kernel RDMA into write-once HBM slots [n, BH, T,
// D] (O(T_global) per device), a comm-driver grid sweep forwards them, and
// semaphores plus a barrier order arrival before use. That works because a
// TPU grid runs in order, so a wait in a later iteration is safe. An H100
// runs a launch's blocks in no order, and a block that spins on a flag set
// by another block of the same launch can starve it of an SM and hang. So
// this kernel PULLS instead: each block reads every visiting K/V block
// straight from its owner's memory, through a table of the n ranks' K and
// V tensor maps. There is no gather buffer, no semaphore, no barrier.
// On one card the table holds local addresses, and stream order already
// makes every rank's K/V resident before any rank's launch; ranks on
// several cards would put peer (NVLink) addresses in the same table. The
// trade for that later multi-card kernel: every Q tile re-reads each
// visiting block from its peer, where the TPU moves each block once per
// hop.
//
// What bounds it on this card: operations. At the training shapes (B 8,
// H 16, 512 rows a rank, D 64, causal, n = 4) the four launches do ~69
// GFLOP over the 6 full and 4 half visible blocks against ~135 MB of
// inputs and outputs, so the products belong on the tensor cores. The
// kernel (`ring_fwd_kernel<DIM>`) is the flash forward's persistent
// Hopper grid (`hopper_forward`, flash_tile.cuh, which says what bounds it
// in fact, the softmax's instruction rate, and its register and
// shared-memory budget) walking the (b*h, 192 query rows at 64, 128 at
// 128) tiles of rank r with one key segment per visible ring step: its
// producer thread picks the owner's K/V tensor maps for each step and
// keeps TMA loads in flight across the step boundary, the consumer
// warpgroups' wgmma pipeline runs on across it, and m, l and the
// accumulator carry across every step of the ring. The tensor maps are
// encoded on the host for each launch (1 + 2n of them;
// `flashy_tensor_map_us` measures one) and travel in a __grid_constant__
// table (2 x kMaxRanks maps of 128 bytes, 16 KB of the 32,764 bytes a
// launch's parameters may take). Left for later: the ranks' launches as
// one grid (rank 0's launch holds a quarter of rank 3's work), and the
// global [B, T, H, D] tensors with their row stride in the table instead
// of per-layer block copies.
//
// Where it could go wrong, and what holds it:
//   * the causal predicate per rank: rank r visits steps 0..r only; the
//     step-0 triangle is q_pos >= k_pos within the block (offset 0), the
//     other visible steps are fully visible;
//   * state across steps: m, l and acc carry straight from the last tile
//     of one step to the first of the next, one rescale per tile, none at
//     a step boundary (rescaling there too would scale acc twice);
//   * a ragged T (not a multiple of 64): keys k0 + c >= T are masked and
//     their rows load as zeros, query rows past T are not stored;
//   * the table's lifetime: it is a __grid_constant__ parameter, copied into the launch's parameter
//     space when the launch is enqueued, so it lives exactly as long as
//     the launch and no host or device buffer has to outlive it;
//   * the K/V ring across ring steps: the producer and the
//     consumers walk the same sequence of (step, tile) pairs and count
//     stages and barrier phases over the whole sequence, so a step that
//     ends on a ragged tile or holds one tile hands over cleanly;
//   * a rank with no visible step (none in self-attention, where step 0
//     is always visible): its rows keep m = NEG_INF, l = 0 and store zero
//     output and lse ~NEG_INF, the flash convention for a row that sees
//     no key.
#include <chrono>

#include "flash_tile.cuh"

namespace {

constexpr int kMaxRanks = 64;

// the n ranks' K and V tensor maps
struct RankMaps {
  CUtensorMap k[kMaxRanks];
  CUtensorMap v[kMaxRanks];
};

struct RingGeometry {
  int B, H, T;      // one rank's block: [B, T, H, DIM]
  int n, rank;      // ring size, this launch's rank
  int causal;
  float scale;
};

// The flash forward's persistent grid over the (b*h, query rows) tiles of
// rank g.rank at head_dim DIM; one key segment per visible ring step,
// owner (rank - step) mod n, the step-0 triangle at offset 0.
template <int DIM>
__global__ void __launch_bounds__(hopper::Fwd<DIM>::kThreads, 1)
ring_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ RankMaps maps,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                const RingGeometry g) {
  extern __shared__ unsigned char hopper_smem[];
  const int steps = g.causal ? g.rank + 1 : g.n;  // s > rank: the future
  const int rank = g.rank, n = g.n, T = g.T, causal = g.causal;
  hopper::hopper_forward<DIM>(
      hopper_smem, &q_map, steps,
      [&maps, rank, n, T, causal](int step) {
        const int owner = (rank - step + n) % n;
        return hopper::Segment{&maps.k[owner], &maps.v[owner], T, 0,
                               causal && step == 0};
      },
      out, lse, g.B * g.H, g.H, g.T, g.scale);
}

// a cudaError_t, or hopper::kTensorMapError + a CUresult
template <int DIM>
int forward(const void* q, void* out, float* lse, const void* const* k,
            const void* const* v, const RingGeometry& g,
            cudaStream_t stream) {
  CUtensorMap q_map;
  RankMaps maps;
  int err = hopper::encode_rows<DIM>(&q_map, q, g.B, g.T, g.H);
  for (int i = 0; i < g.n && err == 0; ++i) {
    err = hopper::encode_rows<DIM>(&maps.k[i], k[i], g.B, g.T, g.H);
    if (err == 0)
      err = hopper::encode_rows<DIM>(&maps.v[i], v[i], g.B, g.T, g.H);
  }
  if (err != 0) return err;
  using F = hopper::Fwd<DIM>;
  err = cudaFuncSetAttribute(ring_fwd_kernel<DIM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(F::kSmemBytes));
  if (err != cudaSuccess) return err;
  const int blocks = hopper::persistent_blocks(g.B * g.H * F::q_tiles(g.T));
  ring_fwd_kernel<DIM><<<blocks, F::kThreads, F::kSmemBytes, stream>>>(
      q_map, maps, static_cast<__nv_bfloat16*>(out), lse, g);
  return cudaGetLastError();
}

}  // namespace

// One rank's launch over bf16 [B, T, H, D] blocks, D 64 or 128; k and v:
// the n ranks' block pointers, in rank order. Returns a cudaError_t (0 =
// launched), or for a refused tensor map hopper::kTensorMapError + its
// CUresult.
extern "C" int flashy_ring_forward(const void* q, const void* const* k,
                                   const void* const* v, int n, int rank,
                                   void* out, float* lse, int B, int H,
                                   int T, int D, int causal, float scale,
                                   void* stream) {
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n || B < 1 || H < 1 ||
      T < 1 || (D != 64 && D != 128) ||
      static_cast<long long>(B) * H * ((T + kBlock - 1) / kBlock) >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n; ++i)
    if (k[i] == nullptr || v[i] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  const RingGeometry g{B, H, T, n, rank, causal ? 1 : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? forward<64>(q, out, lse, k, v, g, s)
                 : forward<128>(q, out, lse, k, v, g, s);
}

// Host microseconds to encode one tensor map of a [B, T, H, 64] bf16
// tensor at `base`, the mean over `reps` encodings: a launch encodes 1 +
// 2n of them (two boxes a row at 128 still one map). Negative where the
// map is refused.
extern "C" double flashy_tensor_map_us(const void* base, int B, int T,
                                       int H, int reps) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (hopper::encode_rows<64>(&map, base, B, T, H) != 0) return -1.0;
  const std::chrono::duration<double, std::micro> spent =
      std::chrono::steady_clock::now() - t0;
  return spent.count() / (reps > 0 ? reps : 1);
}
