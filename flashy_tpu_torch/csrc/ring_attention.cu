// Ring attention, forward, on Hopper (sm_90a).
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
// step is the flash forward's own (`forward_tile`, flash_tile.cuh), so a
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
// V base pointers. There is no gather buffer, no semaphore, no barrier.
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
// inputs and outputs, so the products belong on the tensor cores: bf16
// runs the flash forward's mma.sync m16n8k16 tiles with f32 accumulation,
// f32 its ordered FMAs. One block per (64-row Q tile, b*h) of rank r, 256
// threads, loops over the visible steps and over each block's 64-key
// tiles; S and P live in shared memory one f32 tile at a time, the
// running statistics in shared memory and the accumulator in registers,
// across every step of the ring.
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
//   * the pointer table's lifetime: it is a __grid_constant__ parameter,
//     copied into the launch's parameter space when the launch is
//     enqueued, so it lives exactly as long as the launch and no host or
//     device buffer has to outlive it;
//   * a rank with no visible step (none in self-attention, where step 0
//     is always visible): its rows keep m = NEG_INF, l = 0 and store zero
//     output and lse ~NEG_INF, the flash convention for a row that sees
//     no key.
#include "flash_tile.cuh"

namespace {

constexpr int kMaxRanks = 64;

// the n ranks' K and V base pointers, [B, T, H, kDim] contiguous each
struct RankTable {
  const void* k[kMaxRanks];
  const void* v[kMaxRanks];
};

struct RingGeometry {
  int B, H, T;      // one rank's block: [B, T, H, kDim]
  int n, rank;      // ring size, this launch's rank
  int causal;
  float scale;
};

// One block per (b*h, 64-row Q tile) of rank g.rank; q and out are that
// rank's [B, T, H, kDim] blocks, lse its [B, H, T] f32 rows.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ring_fwd_kernel(const T* __restrict__ q, T* __restrict__ out,
                float* __restrict__ lse, const __grid_constant__ RankTable table,
                const RingGeometry g) {
  const int bh = blockIdx.x, qi = blockIdx.y;
  const int b = bh / g.H, h = bh - b * g.H;
  const int q0 = qi * kBlock;

  extern __shared__ float smem[];
  const ForwardSmem s = forward_smem(smem);
  float acc[4][4];
  forward_begin(s, q, b, h, q0, g.T, g.H, acc);
  const int steps = g.causal ? g.rank + 1 : g.n;  // s > rank: the future
  const int last_tile = (g.T - 1) / kBlock;
  for (int step = 0; step < steps; ++step) {
    const int owner = (g.rank - step + g.n) % g.n;
    const T* k = static_cast<const T*>(table.k[owner]);
    const T* v = static_cast<const T*>(table.v[owner]);
    const bool diag = g.causal && step == 0;
    const int last = diag ? qi : last_tile;   // the triangle ends at qi
    for (int ki = 0; ki <= last; ++ki) {
      const int k0 = ki * kBlock;
      forward_tile<T>(
          s, k, v, b, h, k0, g.T, g.H, g.scale,
          [&](int r, int c) {
            return k0 + c < g.T && (!diag || q0 + r >= k0 + c);
          },
          acc);
    }
  }
  forward_end(s, out, lse, b, h, q0, g.T, g.H, acc);
}

template <typename T>
cudaError_t forward(const void* q, void* out, float* lse,
                    const RankTable& table, const RingGeometry& g,
                    cudaStream_t stream) {
  auto kernel = ring_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFwdSmem));
  if (err != cudaSuccess) return err;
  dim3 grid(g.B * g.H, (g.T + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, kFwdSmem, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(out), lse, table, g);
  return cudaGetLastError();
}

}  // namespace

// One rank's launch. dtype: 0 f32, 1 bf16; k and v: the n ranks' block
// pointers, in rank order. Returns a cudaError_t (0 = launched).
extern "C" int flashy_ring_forward(int dtype, const void* q,
                                   const void* const* k,
                                   const void* const* v, int n, int rank,
                                   void* out, float* lse, int B, int H,
                                   int T, int D, int causal, float scale,
                                   void* stream) {
  if ((dtype != 0 && dtype != 1) || n < 1 || n > kMaxRanks || rank < 0 ||
      rank >= n || B < 1 || H < 1 || T < 1 || D != kDim ||
      static_cast<long long>(B) * H > 0x7fffffffLL ||
      (T + kBlock - 1) / kBlock > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  RankTable table{};
  for (int i = 0; i < n; ++i) {
    if (k[i] == nullptr || v[i] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    table.k[i] = k[i];
    table.v[i] = v[i];
  }
  const RingGeometry g{B, H, T, n, rank, causal ? 1 : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? forward<float>(q, out, lse, table, g, s)
                 : forward<__nv_bfloat16>(q, out, lse, table, g, s));
}
