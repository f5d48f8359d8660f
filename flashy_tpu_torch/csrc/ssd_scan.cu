// SSD chunked scan on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of flashy_tpu/ops/ssd_scan.py:
// `_fused_ssd_body`, launched by `_fused_call`. It computes what that
// body computes. For each (batch b, head h) the sequence is cut into
// chunks of C tokens (the last one may be the sub-chunk tail), the f32
// state S [Dh, N] carried across them. Per chunk of L <= C tokens, with
// la the f32 log-decays:
//   seg[t, s] = sum_{s<r<=t} la_r      decay = exp(seg) on t >= s
//   incl[t]   = sum_{r<=t} la_r        suffix[s] = sum_{r>s} la_r
//   total     = sum_r la_r
//   y[t]      = sum_{s<=t} (c_t.b_s) decay[t, s] v_s + exp(incl[t]) (S c_t)
//   S         = exp(total) S + sum_s v_s (x) b_s exp(suffix[s])
// Every one of those sums is a DIRECT sum of la values, never a
// difference of cumulative sums: at a segment reset la = -1e30, which a
// difference would cancel into garbage, while a direct sum holding it
// stays near -1e30 and expf of it is exactly 0. Only y is rounded to the
// input dtype, as the TPU body does (`y.astype(y_ref.dtype)`).
//
// Inputs are read where they lie: c, b, v [B, T, H, *] and la [B, T, H]
// at their element strides (the serving path hands in slices of one
// fused projection [B, T, H, 2N+Dh+1]), the token mask [B, T] applied on
// the way in (a masked token gets b = 0 and la = 0, the plain version's
// values), y written in [B, T, H, Dh]. One launch per call.
//
// Determinism is the contract the serving engine leans on: splitting a
// stream at a chunk multiple and passing the state must give the same
// bits as one call, and a right-padded chunk (b = 0, la = 0 on the pad
// tokens) the same bits as the unpadded tail. Each output is one fixed
// sequence of operations on its chunk's data and the incoming state,
// fixed by the positions within the chunk alone: no atomics, no order
// that depends on the launch or on where the chunk sits in a tile, and
// pad tokens entering only as exact zeros (zero products, + 0.0f).
//
// What bounds it on this card. At the serving widths (H 16, Dh 64, N 16,
// C 64, bf16) a token brings (2N + Dh) x 2 + 4 = 196 bytes in and takes
// Dh x 2 = 128 out, and its four products cost ~9.3k flops: the function
// is bound by bytes, 0.0130 ms at [8, 1024] over 3.35 TB/s. The products
// are ~30 flops a byte, so on f32 FMAs (67 TFLOP/s) they alone would
// take twice the byte bound: the bf16 kernel runs them on the tensor
// cores. What bounds this kernel is latency, not bytes or flops: a
// [1, 64] prefill slice is 16 heads of one chunk, 16 blocks on 132 SMs,
// and each block's work is a few dependent phases between barriers with
// 16 warps (the register file's limit at 128 registers); at [8, 1024]
// the same phases run once a tile, and unpacking the staged rows and
// storing y take the most (PERF.md, the SSD scan's findings).
//
// bf16 design (`ssd_bf16_kernel`): one 512-thread block per (b, h)
// walks the sequence in tiles of up to 256 rows: up to 4 chunks, each
// padded to a multiple of 16 rows with zeros, so every 16-row band and
// every 16-token key block lies in one chunk and starts at a fixed
// position within it. The next tile is in flight while the current one
// computes. The per-head slices of a projection row are 194 bytes apart
// (2-byte aligned), so neither TMA's tensor copies nor 16-byte
// `cp.async` can read them where they start: each token row's slices are
// copied as the 16-byte-aligned span that covers them (one 1-D bulk copy,
// TMA's plain form, completing on an mbarrier) into a staging area, and
// shifted into padded, ldmatrix-friendly rows when the tile is unpacked.
// Within a tile everything that does not depend on the incoming state
// runs for all chunks at once; only the state is chained:
//   1. decay sums (direct): per 16-row block an inclusive prefix and an
//      exclusive suffix by half-warp shuffles;
//   2. tables: the block sums combined in ascending order per chunk;
//      exp(incl), exp(total), exp(seg) inside each row's own block (a
//      direct sum from the row down), and the dS weights b exp(suffix)
//      as three exact bf16 planes;
//   3. one warp per 16-row band: scores c.b^T on `mma.sync` (k16 = N),
//      times exp(seg) (seg = suffix-in-block + blocks between + prefix-
//      in-block, or the diagonal table), then P.V on `mma.sync` with the
//      f32 P as two exact bf16 planes (hi, mid: P to 2^-17 relative)
//      against bf16 v: y_intra stays in registers; meanwhile the last
//      warps take dS = v^T (b exp(suffix)) per chunk on `mma.sync`,
//      plane-major (all k of lo, then mid, then hi), so the large partial
//      sums see few k16 steps of the accumulator's truncation (the
//      state's 1e-5 bar);
//   4. the chain: S_j = fmaf(exp(total_j), S_{j-1}, dS_j) elementwise,
//      each thread walking its state elements through the tile's chunks;
//      every S_{j-1} split into three bf16 planes for step 5;
//   5. each band: y_inter = c.S_{j-1}^T on `mma.sync` (three planes), y =
//      fmaf(exp(incl), y_inter, y_intra), rounded to bf16, staged in
//      shared memory and stored a row at a time.
// The scores are computed once per (b, h, chunk) and shared by every row
// of Dh. The tile kernel takes N <= 16 and even Dh <= 64 (zero-padded to
// 16 and 64), the serving widths.
//
// FMA kernel (`ssd_fma_kernel`): f32 (the exact-serving path and the f32
// oracle) stays on f32 FMAs, never TF32, and bf16 at the widths the tile
// kernel does not take (N > 16, as Mamba-2's 128; Dh > 64 or odd) runs
// there too, so every width has a kernel: one block per
// (b, h, group of up to 16 state rows) walks the chunks in order, every
// sum an ascending f32 chain, with the same strided loads, mask and
// output layout. c and b pass through shared memory 64 state columns at
// a time (the dot products' partial sums wait there between column
// tiles), so its ~190 KB hold any chunk up to 256 at N up to 256 and
// beyond (Mamba-2's N 128 at chunk 256, the chunk `default_chunk` picks
// for a 1024-token prompt, needed 358 KB before the columns were tiled).
// The wrapper picks the kernel from the widths (`ops/ssd_scan.py`
// `kernel_route`), one launch counter each.
//
// Tried and dropped (PERF.md, the SSD scan's design rounds): 4-byte and
// 16-byte `cp.async` staging (the issuing warps stall on the copies), unpacking
// one item a thread (instruction-bound), dS and the chain before the
// bands (slower), three planes of P (4% slower, no bar needs them), and
// the chunk-parallel grid: one block a tile, tickets in launch order, each
// tile's outgoing state published (release) and acquired by the next
// tile's block before its chain step. It lost at the main path's shapes
// (one chunk a head at [1, 64], so the same 16 blocks plus the ticket;
// at [8, 1024] 512 blocks at one an SM lose the next tile's copy in
// flight) and won only where B x H leaves SMs idle ([1, 4096]).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The launch's argument block (mirrored by ops/ssd_scan.py `_SsdArgs`):
// pointers, element strides (batch, token, head; the last dimension is
// contiguous), sizes. mask may be null (every token real), state_in null
// (a zero state).
struct SsdArgs {
  const void* c;
  const void* b;
  const void* v;
  const float* la;
  const unsigned char* mask;
  const float* state_in;
  void* y;
  float* state_out;
  long long c_stride[3];
  long long b_stride[3];
  long long v_stride[3];
  long long la_stride[3];
  long long mask_stride[2];
  int B, T, H, N, Dh, C;
  int cbv;  // b and v follow c in one row (one projection): one copy a row
};

namespace {

constexpr int kMaxChunk = 256;
constexpr unsigned kFull = 0xffffffffu;

// ----------------------------------------------------------------------
// FMA chains from shared memory: f32, and bf16 at other widths
// ----------------------------------------------------------------------
constexpr int kF32Threads = 256;
constexpr int kRowTile = 64;         // query rows of scores held at once
constexpr int kGroup = 16;           // state rows (of Dh) per block
constexpr int kNTile = 64;           // state columns (of N) staged at once
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_y(float* y, float x) { *y = x; }
__device__ __forceinline__ void store_y(__nv_bfloat16* y, float x) {
  *y = __float2bfloat16_rn(x);  // round to nearest even, as astype does
}

// f32 floats of shared memory `ssd_fma_kernel` takes at chunk C, N
__host__ __device__ __forceinline__ size_t fma_smem_floats(int C, int N) {
  const int nt = N < kNTile ? N : kNTile;
  const int R = C < kRowTile ? C : kRowTile;
  return static_cast<size_t>(C + R) * (nt + 1) +
         static_cast<size_t>(C) * kGroup +
         static_cast<size_t>(kGroup) * (N + 1) +
         static_cast<size_t>(R) * kGroup + 3 * static_cast<size_t>(C) +
         static_cast<size_t>(R) * (C + 1);
}

// DT: the dtype of c, b, v and y. Grid: (ceil(Dh / kGroup), H, B). Each
// block walks the chunks of its (b, h) in order for its (up to) kGroup
// state rows, recomputing the scores (the f32 path is the oracle and the
// exact-serving path, not the hot one). c and b pass through shared
// memory kNTile state columns at a time, so any N fits at any chunk up
// to kMaxChunk: the dot products c.b and c.S are FMA chains in ascending
// n whose partial sums wait in shared memory (f32, exact) between
// column tiles, so the tiling changes no operation's order.
template <typename DT>
__global__ void __launch_bounds__(kF32Threads)
ssd_fma_kernel(const SsdArgs a) {
  const int d0 = blockIdx.x * kGroup;
  const int G = min(kGroup, a.Dh - d0);  // this block's state rows
  const int h = blockIdx.y, bb = blockIdx.z;
  const int H = a.H, T = a.T, N = a.N, Dh = a.Dh, C = a.C;
  const size_t bh = static_cast<size_t>(bb) * H + h;
  const int tid = threadIdx.x;
  const int NT = min(N, kNTile);
  const int ldn = NT + 1;  // padded rows: no bank conflicts across tokens
  const int lds = N + 1;
  const int ldp = C + 1;
  const int R = min(kRowTile, C);

  extern __shared__ float smem[];
  float* b_s = smem;                // [C][ldn] a column tile of b; later
                                    // b * exp(suffix)
  float* c_s = b_s + C * ldn;       // [R][ldn] the row tile's c, same cols
  float* v_s = c_s + R * ldn;       // [C][kGroup] this block's state rows
  float* st_s = v_s + C * kGroup;   // [kGroup][lds] the carried state rows
  float* in_s = st_s + kGroup * lds;  // [R][kGroup] partial c.S
  float* la_s = in_s + R * kGroup;  // [C]
  float* ein_s = la_s + C;          // [C] exp(incl)
  float* esu_s = ein_s + C;         // [C] exp(suffix)
  float* p_s = esu_s + C;           // [R][ldp] scores x decay
  __shared__ float etot;            // exp(total)

  const DT* cg = static_cast<const DT*>(a.c) + bb * a.c_stride[0] +
                 h * a.c_stride[2];
  const DT* bg = static_cast<const DT*>(a.b) + bb * a.b_stride[0] +
                 h * a.b_stride[2];
  const DT* vg = static_cast<const DT*>(a.v) + bb * a.v_stride[0] +
                 h * a.v_stride[2] + d0;
  const float* lag = a.la + bb * a.la_stride[0] + h * a.la_stride[2];
  const unsigned char* mg =
      a.mask ? a.mask + bb * a.mask_stride[0] : nullptr;
  DT* yg = static_cast<DT*>(a.y) + d0;

  // columns n0..n0+nw-1 of b for tokens base..base+rows-1 (masked tokens
  // zero), and of c for tokens base+r0..
  const auto load_b = [&](int base, int rows, int n0, int nw) {
    for (int i = tid; i < rows * nw; i += kF32Threads) {
      const int t = i / nw, n = i - t * nw;
      const long long tok = base + t;
      const bool keep = !mg || mg[tok * a.mask_stride[1]];
      b_s[t * ldn + n] =
          keep ? to_float(bg[tok * a.b_stride[1] + n0 + n]) : 0.f;
    }
  };
  const auto load_c = [&](int base, int rows, int n0, int nw) {
    for (int i = tid; i < rows * nw; i += kF32Threads) {
      const int t = i / nw, n = i - t * nw;
      c_s[t * ldn + n] =
          to_float(cg[(base + t) * static_cast<long long>(a.c_stride[1]) +
                      n0 + n]);
    }
  };

  for (int i = tid; i < G * N; i += kF32Threads) {
    const int d = i / N, n = i - d * N;
    st_s[d * lds + n] =
        a.state_in ? a.state_in[(bh * Dh + d0 + d) * N + n] : 0.f;
  }

  for (int base = 0; base < T; base += C) {
    const int L = min(C, T - base);
    __syncthreads();  // the previous chunk is done with the tiles
    for (int i = tid; i < L * G; i += kF32Threads) {
      const int t = i / G, d = i - t * G;
      v_s[t * kGroup + d] = to_float(vg[(base + t) * a.v_stride[1] + d]);
    }
    for (int t = tid; t < L; t += kF32Threads) {
      const long long tok = base + t;
      const bool keep = !mg || mg[tok * a.mask_stride[1]];
      la_s[t] = keep ? lag[tok * a.la_stride[1]] : 0.f;
    }
    __syncthreads();

    for (int t = tid; t < L; t += kF32Threads) {
      float incl = 0.f, suffix = 0.f;
      for (int r = 0; r <= t; ++r) incl += la_s[r];
      for (int r = t + 1; r < L; ++r) suffix += la_s[r];
      ein_s[t] = expf(incl);
      esu_s[t] = expf(suffix);
    }
    if (tid == 0) {
      float total = 0.f;
      for (int r = 0; r < L; ++r) total += la_s[r];
      etot = expf(total);
    }

    for (int r0 = 0; r0 < L; r0 += R) {
      const int rows = min(R, L - r0);
      const int cols = r0 + rows;  // key columns s <= t of the tile's rows
      for (int i = tid; i < rows * cols; i += kF32Threads)
        p_s[(i / cols) * ldp + i % cols] = 0.f;
      for (int i = tid; i < rows * kGroup; i += kF32Threads) in_s[i] = 0.f;
      // c.b of the rows against their columns and c.S, a column tile at a
      // time
      for (int n0 = 0; n0 < N; n0 += NT) {
        const int nw = min(NT, N - n0);
        __syncthreads();  // the previous tile's readers are done
        load_b(base, cols, n0, nw);
        load_c(base + r0, rows, n0, nw);
        __syncthreads();
        for (int i = tid; i < rows * cols; i += kF32Threads) {
          const int t = i / cols, s = i - t * cols;
          if (s > r0 + t) continue;
          float dot = p_s[t * ldp + s];
          for (int n = 0; n < nw; ++n)
            dot = fmaf(c_s[t * ldn + n], b_s[s * ldn + n], dot);
          p_s[t * ldp + s] = dot;
        }
        for (int i = tid; i < rows * G; i += kF32Threads) {
          const int t = i / G, d = i - t * G;
          float inter = in_s[t * kGroup + d];
          for (int n = 0; n < nw; ++n)
            inter = fmaf(c_s[t * ldn + n], st_s[d * lds + n0 + n], inter);
          in_s[t * kGroup + d] = inter;
        }
      }
      __syncthreads();
      // scores x decay: one thread per (column, slice of the tile's rows)
      const int slices = max(1, kF32Threads / cols);
      const int per = (rows + slices - 1) / slices;
      for (int i = tid; i < cols * slices; i += kF32Threads) {
        const int s = i % cols, q = i / cols;
        const int lo = max(r0 + q * per, s);
        const int hi = min(r0 + (q + 1) * per, r0 + rows);
        if (lo >= hi) continue;
        float seg = 0.f;
        for (int r = s + 1; r <= lo; ++r) seg += la_s[r];
        for (int t = lo; t < hi; ++t) {
          if (t > lo) seg += la_s[t];
          float* p = p_s + (t - r0) * ldp + s;
          *p = *p * expf(seg);
        }
      }
      __syncthreads();
      for (int i = tid; i < rows * G; i += kF32Threads) {
        const int t = r0 + i / G, d = i % G;
        const float* p_row = p_s + (t - r0) * ldp;
        float intra = 0.f;
        for (int s = 0; s <= t; ++s)
          intra = fmaf(p_row[s], v_s[s * kGroup + d], intra);
        const float inter = in_s[(t - r0) * kGroup + d];
        store_y(&yg[((static_cast<size_t>(bb) * T + base + t) * H + h) * Dh +
                    d],
                intra + ein_s[t] * inter);
      }
      __syncthreads();  // before the next row tile clears p_s and in_s
    }

    // S = exp(total) S + v^T (b exp(suffix)), after every row of the
    // chunk has read the incoming S, a column tile at a time
    for (int n0 = 0; n0 < N; n0 += NT) {
      const int nw = min(NT, N - n0);
      __syncthreads();
      load_b(base, L, n0, nw);
      __syncthreads();
      for (int i = tid; i < L * nw; i += kF32Threads) {
        const int s = i / nw, n = i - s * nw;
        b_s[s * ldn + n] *= esu_s[s];
      }
      __syncthreads();
      for (int i = tid; i < G * nw; i += kF32Threads) {
        const int d = i / nw, n = i - d * nw;
        float acc = 0.f;
        for (int s = 0; s < L; ++s)
          acc = fmaf(v_s[s * kGroup + d], b_s[s * ldn + n], acc);
        st_s[d * lds + n0 + n] = etot * st_s[d * lds + n0 + n] + acc;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * N; i += kF32Threads) {
    const int d = i / N, n = i - d * N;
    a.state_out[(bh * Dh + d0 + d) * N + n] = st_s[d * lds + n];
  }
}

template <typename DT>
cudaError_t launch_fma(const SsdArgs& a, cudaStream_t stream) {
  const size_t smem = fma_smem_floats(a.C, a.N) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_fma_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((a.Dh + kGroup - 1) / kGroup, a.H, a.B);
  ssd_fma_kernel<DT><<<grid, kF32Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ----------------------------------------------------------------------
// bf16: tiles of chunks on the tensor cores, only the state chained
// ----------------------------------------------------------------------
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 256;             // rows of a tile
constexpr int kBlocks = kTile / 16;    // 16-row blocks of a tile
constexpr int kTileChunks = 4;         // most chunks in a tile
constexpr int kN = 16;                 // N, zero-padded (one k16 step)
constexpr int kDh = 64;                // Dh, zero-padded (8 n8 tiles)
constexpr int kLdc = 24;               // c, b rows: 48 bytes
constexpr int kLdv = 72;               // v rows: 144 bytes
constexpr int kLds = 24;               // state plane rows [d][n]
constexpr int kLdw = kTile + 8;        // weight plane rows [n][s]
constexpr int kLdd = kTile + 4;        // diagonal decay rows [key][row]
constexpr int kChunksC = 3, kChunksV = 9;  // 16-byte chunks covering a slice
constexpr int kStageChunks = 2 * kChunksC + kChunksV;  // staged chunks a row
constexpr int kState = kDh * kN;       // state elements (padded)
// bf16 planes (hi, mid, lo) of each f32 operand that a product uses: P
// in P.V (hi and mid: P to 2^-17 relative, far inside y's one-ulp bar),
// the weights b exp(suffix) in dS (all three: the state's 1e-5 bar) and
// the state in c.S^T (all three; two were no faster, PERF.md)
constexpr int kPlanesP = 2, kPlanesW = 3, kPlanesS = 3;

struct __align__(16) TileSmem {
  __nv_bfloat16 c[kTile * kLdc];
  __nv_bfloat16 b[kTile * kLdc];
  __nv_bfloat16 v[kTile * kLdv];
  // b exp(suffix) as bf16 planes hi, mid, lo, transposed: [3][n][s]
  __nv_bfloat16 w[3 * kN * kLdw];
  // S entering each chunk as bf16 planes hi, mid, lo: [chunk][3][d][n]
  __nv_bfloat16 planes[kTileChunks * 3 * kDh * kLds];
  uint4 stage[kTile * kStageChunks];   // the next tile, as copied
  float ds[kTileChunks * kState];      // dS per chunk, [d][n]
  float carry[kState];                 // the state, [d][n]; thread e owns e
  float diag[16 * kLdd];               // exp(seg) in a row's block, [key][row]
  float la[kTile];                     // masked log-decays
  float pre[kTile];                    // inclusive prefix in the block
  float suf[kTile];                    // exclusive suffix in the block
  float einc[kTile];                   // exp(incl)
  float la_next[kTile];                // staged la
  uint32_t mask_next[kTile];           // staged words holding mask bytes
  uint32_t info_next[kTile];           // staged rows: offsets, mask byte
  uint64_t full;                       // the staged tile has landed
  float blk[kBlocks];                  // block sums
  float mid[kBlocks * kBlocks];        // sums of the blocks between two
  float etot[kTileChunks];             // exp(total) per chunk
};
static_assert(sizeof(TileSmem) <= kMaxSmem, "tile exceeds shared memory");
static_assert(sizeof(TileSmem::ds) >= 8 * 16 * kDh * 2 &&
                  sizeof(TileSmem::w) >= 8 * 16 * kDh * 2,
              "y of eight bands fits in ds and in w");

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// x == hi + mid + lo exactly (each subtraction exact; `split_bf16` of
// csrc/grouped_matmul.cu)
__device__ __forceinline__ void split3(float x, __nv_bfloat16* p) {
  p[0] = __float2bfloat16_rn(x);
  const float r = __fsub_rn(x, __bfloat162float(p[0]));
  p[1] = __float2bfloat16_rn(r);
  p[2] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(p[1])));
}

// the three planes of a pair of f32 values, packed: out[p] for plane p
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t* out) {
  __nv_bfloat16 p0[3], p1[3];
  split3(x0, p0);
  split3(x1, p1);
#pragma unroll
  for (int p = 0; p < 3; ++p) out[p] = pack2(p0[p], p1[p]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d = a(16x16, row) b(16x8, col) + d: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: the B fragments of two n8 tiles
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row) {
  const unsigned s = smem_u32(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// `size` bytes (a multiple of 16, both addresses 16-byte aligned) from
// global memory by the bulk-copy engine; completes on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, uintptr_t src,
                                          uint32_t size, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(size), "r"(smem_u32(bar))
      : "memory");
}

// orders this thread's earlier generic accesses of shared memory before
// its later bulk copies into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// `bytes` more to come from bulk copies in the current phase of `bar`
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
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

// Until the phase of parity `parity` has completed. A phase that never
// completes is a bug of the kernel: after ~10 s of clock the thread traps,
// which the caller sees as a launch failure, instead of holding the card.
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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = smem_u32(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The tiles of a sequence: chunk J of C tokens sits in tile J / nc at
// rows (J % nc) Cp .. + C; rows C .. Cp of each chunk, and rows past the
// sequence, are zero rows.
struct Geometry {
  int C, Cp, nb, nc, nchunks, ntiles;
  __device__ Geometry(int T, int chunk) : C(chunk) {
    Cp = (C + 15) & ~15;
    nb = Cp >> 4;
    nc = min(kTileChunks, kTile / Cp);
    nchunks = (T + C - 1) / C;
    ntiles = (nchunks + nc - 1) / nc;
  }
};
struct Tile {
  int J0, chunks, rows;
  __device__ Tile(const Geometry& G, int st) {
    J0 = st * G.nc;
    chunks = min(G.nc, G.nchunks - J0);
    rows = chunks * G.Cp;
  }
};

// byte address of the slice (b, tok, h) of c (which 0), b (1) or v (2)
__device__ __forceinline__ uintptr_t slice_at(const SsdArgs& a, int which,
                                              int bb, long long tok, int h) {
  const long long* s = which == 0 ? a.c_stride
                       : which == 1 ? a.b_stride : a.v_stride;
  const void* base = which == 0 ? a.c : which == 1 ? a.b : a.v;
  return reinterpret_cast<uintptr_t>(base) +
         2 * (bb * s[0] + tok * s[1] + h * s[2]);
}

// Issue the copies of a tile, one row a thread of the last kTile threads
// (warps 8-15, idle during step 1): the 16-byte-aligned span that covers
// the row's c, b and v slices (one span when they are adjacent, as in
// the model's projection, else one a slice) as bulk copies (TMA's 1-D
// form, completing on `S.full`; a span holds no byte outside the 16-byte
// granules of its slices, so no copy leaves the pages the tensor maps;
// one copy a row instead of three is 15% of [1, 64]'s time, PERF.md),
// la and the 4-byte word that holds the token's mask byte by
// cp.async, and the row's layout in `S.info_next`: byte w (w = 0 c, 1 b,
// 2 v) the slice's first byte in the staged row, bits 24-25 the mask
// byte in its word, bit 31 a real token. Each copy's bytes are expected
// on `S.full` before it is issued; every issuing thread then arrives
// once.
__device__ __forceinline__ void issue_tile(TileSmem& S, const SsdArgs& a,
                                           const Geometry& G, const Tile& t,
                                           int bb, int h) {
  const int r = static_cast<int>(threadIdx.x) - (kThreads - kTile);
  if (r < 0) return;
  long long tok = -1;
  if (r < t.rows) {
    const int q = r / G.Cp, i = r - q * G.Cp;
    const int at = (t.J0 + q) * G.C + i;
    if (i < G.C && at < a.T) tok = at;
  }
  uint32_t info = 0;
  if (tok >= 0) {
    fence_proxy_async();  // the block's earlier reads of the staging area
    // one span from c's first byte over c, b and v (a.cbv), else one
    // span a slice; info bits 8w..8w+7: slice w's first byte in the row
    const int spans = a.cbv ? 1 : 3;
    unsigned char* row = reinterpret_cast<unsigned char*>(
        &S.stage[r * kStageChunks]);
    for (int w = 0; w < spans; ++w) {
      const uintptr_t at = slice_at(a, w, bb, tok, h);
      const uint32_t shift = static_cast<uint32_t>(at & 15);
      const uint32_t bytes = a.cbv ? 2 * (2 * a.N + a.Dh)
                                   : 2 * (w == 2 ? a.Dh : a.N);
      const uint32_t size = (shift + bytes + 15) & ~15u;
      const uint32_t first = w * 16 * kChunksC + shift;
      info |= a.cbv ? first | (first + 2 * a.N) << 8 | (first + 4 * a.N) << 16
                    : first << (8 * w);
      mbar_expect_tx(&S.full, size);
      bulk_copy(row + w * 16 * kChunksC, at & ~uintptr_t(15), size, &S.full);
    }
    info |= 1u << 31;
    cp_async4(&S.la_next[r], a.la + bb * a.la_stride[0] +
                                 tok * a.la_stride[1] + h * a.la_stride[2]);
    if (a.mask) {
      const uintptr_t m = reinterpret_cast<uintptr_t>(
          a.mask + bb * a.mask_stride[0] + tok * a.mask_stride[1]);
      info |= static_cast<uint32_t>(m & 3) << 24;
      cp_async4(&S.mask_next[r],
                reinterpret_cast<const void*>(m & ~uintptr_t(3)));
    }
  }
  S.info_next[r] = info;
  mbar_arrive(&S.full);
  cp_async_commit();
}

// Unpack the staged tile into the padded rows, one warp a row, kUnpack
// rows at a time (every read of a batch before its writes): slices
// shifted into place, zeros past N and Dh and on zero rows, b zero on
// masked tokens, la the masked log-decays. Lane l holds value pair l (and
// 32 + l): c pairs 0-7, b 8-15, v 16-47.
constexpr int kUnpack = 4;
__device__ __forceinline__ void unpack_tile(TileSmem& S, const SsdArgs& a,
                                            const Tile& t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int which[2], k[2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int col = lane + 32 * pass;
    which[pass] = col < kN / 2 ? 0 : col < kN ? 1 : 2;
    k[pass] = 2 * (col - which[pass] * (kN / 2));
  }
  for (int r0 = warp; r0 < t.rows; r0 += kWarps * kUnpack) {
    uint32_t val[kUnpack][2];
    float la[kUnpack];
#pragma unroll
    for (int u = 0; u < kUnpack; ++u) {
      const int r = r0 + u * kWarps;
      const uint32_t info = r < t.rows ? S.info_next[r] : 0;
      const bool real = info >> 31;
      const bool keep =
          real && (!a.mask ||
                   ((S.mask_next[r] >> (8 * ((info >> 24) & 3))) & 0xffu));
      la[u] = keep ? S.la_next[r] : 0.f;
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        const int w = which[pass], kk = k[pass];
        const int width = w == 2 ? a.Dh : a.N;
        val[u][pass] = 0;
        if (real && (w != 1 || keep) && (pass == 0 || lane < 16)) {
          const unsigned char* from =
              reinterpret_cast<const unsigned char*>(
                  &S.stage[r * kStageChunks]) +
              ((info >> (8 * w)) & 0xffu) + 2 * kk;
          if (kk < width)
            val[u][pass] = *reinterpret_cast<const unsigned short*>(from);
          if (kk + 1 < width)
            val[u][pass] |=
                static_cast<uint32_t>(
                    *reinterpret_cast<const unsigned short*>(from + 2))
                << 16;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnpack; ++u) {
      const int r = r0 + u * kWarps;
      if (r >= t.rows) break;
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        if (pass == 1 && lane >= 16) continue;
        const int w = which[pass], kk = k[pass];
        __nv_bfloat16* dst = w == 0 ? &S.c[r * kLdc + kk]
                             : w == 1 ? &S.b[r * kLdc + kk]
                                      : &S.v[r * kLdv + kk];
        *reinterpret_cast<uint32_t*>(dst) = val[u][pass];
      }
      if (lane == 0) S.la[r] = la[u];
    }
  }
}

// Grid: (H, B). One block per (b, h) walks the tiles of its sequence.
__global__ void __launch_bounds__(kThreads, 1)
ssd_bf16_kernel(const __grid_constant__ SsdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem& S = *reinterpret_cast<TileSmem*>(smem_raw);
  const int h = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;  // mma fragment coordinates
  const int T = a.T;
  const Geometry G(T, a.C);

  // the state elements e = tid, tid + kThreads, ... ([d][n]) this thread
  // carries, in shared memory between tiles
  for (int e = tid; e < kState; e += kThreads) {
    const int d = e / kN, n = e % kN;
    S.carry[e] = a.state_in && d < a.Dh && n < a.N
                     ? a.state_in[((static_cast<size_t>(bb) * a.H + h) *
                                       a.Dh + d) * a.N + n]
                     : 0.f;
  }

  // tile st is staged in phase st of S.full (parity st & 1)
  if (tid == 0) mbar_init(&S.full, kTile);
  __syncthreads();
  issue_tile(S, a, G, Tile(G, 0), bb, h);
  cp_async_wait_all();
  mbar_wait(&S.full, 0);
  __syncthreads();
  unpack_tile(S, a, Tile(G, 0));
  __syncthreads();

  for (int st = 0; st < G.ntiles; ++st) {
    const bool has_next = st + 1 < G.ntiles;
    const Tile cur(G, st);
    if (has_next) issue_tile(S, a, G, Tile(G, st + 1), bb, h);

    // 1. decay sums, direct: prefix and suffix inside each 16-row block
    if (tid < kTile) {  // warps 0-7, every lane (half-warp shuffles)
      const int lane16 = tid & 15;
      const float x = tid < cur.rows ? S.la[tid] : 0.f;
      float p = x, s = x;
#pragma unroll
      for (int d = 1; d < 16; d <<= 1) {
        const float up = __shfl_up_sync(kFull, p, d, 16);
        const float down = __shfl_down_sync(kFull, s, d, 16);
        if (lane16 >= d) p += up;
        if (lane16 + d < 16) s += down;
      }
      float s_ex = __shfl_down_sync(kFull, s, 1, 16);
      if (lane16 == 15) s_ex = 0.f;
      S.pre[tid] = p;
      S.suf[tid] = s_ex;
      if (lane16 == 15) S.blk[tid >> 4] = p;
    }
    __syncthreads();
    // 2. tables: the block sums of a chunk combined in ascending order
    if (tid < cur.rows) {
      // row r: exp(incl), exp(total), the dS weights b exp(suffix)
      const int r = tid, m = r >> 4, first = (r / G.Cp) * G.nb;
      const int last = first + G.nb - 1;
      float before = 0.f, after = 0.f;
      for (int j = first; j < m; ++j) before += S.blk[j];
      for (int j = m + 1; j <= last; ++j) after += S.blk[j];
      S.einc[r] = expf(before + S.pre[r]);
      const float esuf = expf(S.suf[r] + after);
      if (r % G.Cp == 0) {
        float total = 0.f;
        for (int j = first; j <= last; ++j) total += S.blk[j];
        S.etot[r / G.Cp] = expf(total);
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        __nv_bfloat16 p[3];
        split3(__bfloat162float(S.b[r * kLdc + n]) * esuf, p);
#pragma unroll
        for (int j = 0; j < 3; ++j) S.w[(j * kN + n) * kLdw + r] = p[j];
      }
    } else if (tid >= kTile && tid - kTile < cur.rows) {
      // row r: exp(seg) against the keys of its own block, seg summed
      // from the row down; the block pair (m, j): the blocks between
      const int r = tid - kTile, i = r & 15, top = r - i;
      float seg = 0.f;
      S.diag[i * kLdd + r] = 1.f;
      for (int j = i - 1; j >= 0; --j) {
        seg += S.la[top + j + 1];
        S.diag[j * kLdd + r] = expf(seg);
      }
      for (int j = i + 1; j < 16; ++j) S.diag[j * kLdd + r] = 0.f;
      const int m = r / kBlocks, j = r % kBlocks;
      if (j < m && m / G.nb == j / G.nb) {
        float sum = 0.f;
        for (int k = j + 1; k < m; ++k) sum += S.blk[k];
        S.mid[r] = sum;
      }
    }
    __syncthreads();

    // 3. one warp per 16-row band: y_intra = (scores x decay) . v
    const int bands = cur.chunks * G.nb;
    const int bq = warp % cur.chunks, bi = warp / cur.chunks;
    const int r0 = bq * G.Cp + bi * 16;   // the band's first row
    const int band_tok = (cur.J0 + bq) * G.C + bi * 16;
    const bool band = warp < bands && bi * 16 < G.C && band_tok < T;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    uint32_t ca[4] = {0, 0, 0, 0};
    if (band) {
      ca[0] = lds32(&S.c[(r0 + g) * kLdc + 2 * q4]);
      ca[1] = lds32(&S.c[(r0 + g + 8) * kLdc + 2 * q4]);
      ca[2] = lds32(&S.c[(r0 + g) * kLdc + 2 * q4 + 8]);
      ca[3] = lds32(&S.c[(r0 + g + 8) * kLdc + 2 * q4 + 8]);
      const float pre_row[2] = {S.pre[r0 + g], S.pre[r0 + g + 8]};
      const int mi = bq * G.nb + bi;
      for (int kb = 0; kb <= bi; ++kb) {
        const int s0 = bq * G.Cp + kb * 16;  // the key block's first row
        float sc[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* brow = &S.b[(s0 + nt * 8 + g) * kLdc + 2 * q4];
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
          mma_bf16(sc[nt], ca, lds32(brow), lds32(brow + 8));
        }
        // element e of n8 tile nt: row g + 8 (e >> 1), key nt 8 + 2 q4 +
        // (e & 1) of the block
        if (kb < bi) {
          const float between = S.mid[mi * kBlocks + bq * G.nb + kb];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = nt * 8 + 2 * q4 + (e & 1);
              sc[nt][e] *= expf((S.suf[s0 + col] + between) +
                                pre_row[e >> 1]);
            }
        } else {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[nt][e] *= S.diag[(nt * 8 + 2 * q4 + (e & 1)) * kLdd + r0 +
                                  g + 8 * (e >> 1)];
        }
        // P as the A operand, three planes: a0 (row g, keys 2q4..),
        // a1 (row g + 8), a2 (row g, keys + 8), a3 (row g + 8, keys + 8)
        uint32_t pa[4][3];
        split_pair(sc[0][0], sc[0][1], pa[0]);
        split_pair(sc[0][2], sc[0][3], pa[1]);
        split_pair(sc[1][0], sc[1][1], pa[2]);
        split_pair(sc[1][2], sc[1][3], pa[3]);
        const __nv_bfloat16* vrow =
            &S.v[(s0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdv +
                 (lane >> 4) * 8];
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vrow + dp * 16);
#pragma unroll
          for (int p = kPlanesP - 1; p >= 0; --p) {  // lo, mid, hi
            const uint32_t ap[4] = {pa[0][p], pa[1][p], pa[2][p], pa[3][p]};
            mma_bf16(acc[2 * dp], ap, vb[0], vb[1]);
            mma_bf16(acc[2 * dp + 1], ap, vb[2], vb[3]);
          }
        }
      }
    }

    // 4. dS = v^T (b exp(suffix)) of chunk q for state rows 16 dp..: the
    // last warps take it, so one-chunk tiles spread over the SM
    {
      const int item = kWarps - 1 - warp;
      if (item < cur.chunks * 4) {
        const int q = item >> 2, dp = item & 3;
        float dsum[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dsum[nt][e] = 0.f;
        for (int p = kPlanesW - 1; p >= 0; --p) {  // lo, mid, hi: plane-major
          for (int kb = 0; kb < G.nb; ++kb) {
            const int s0 = q * G.Cp + kb * 16;
            // A = plane p of the weights^T: rows n = g, g + 8; keys
            // 2 q4 (+ 8) of the block
            const __nv_bfloat16* wrow =
                &S.w[(p * kN + g) * kLdw + s0 + 2 * q4];
            const uint32_t ap[4] = {lds32(wrow), lds32(wrow + 8 * kLdw),
                                    lds32(wrow + 8),
                                    lds32(wrow + 8 * kLdw + 8)};
            uint32_t vb[4];
            ldmatrix_x4_trans(
                vb, &S.v[(s0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdv +
                         dp * 16 + (lane >> 4) * 8]);
            mma_bf16(dsum[0], ap, vb[0], vb[1]);
            mma_bf16(dsum[1], ap, vb[2], vb[3]);
          }
        }
        // element e of tile nt: n = g + 8 (e >> 1), d = 16 dp + 8 nt +
        // 2 q4 + (e & 1)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = dp * 16 + nt * 8 + 2 * q4 + (e & 1);
            S.ds[q * kState + d * kN + g + 8 * (e >> 1)] = dsum[nt][e];
          }
      }
    }
    __syncthreads();

    // 5. the chain: S_j = exp(total_j) S_{j-1} + dS_j, S_{j-1} kept as
    // planes for chunk j's rows; the last tile's S is the final state
    for (int e = tid; e < kState; e += kThreads) {
      const int d = e / kN, n = e % kN;
      float s = S.carry[e];
      for (int q = 0; q < cur.chunks; ++q) {
        __nv_bfloat16 p[3];
        split3(s, p);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          S.planes[((q * 3 + j) * kDh + d) * kLds + n] = p[j];
        s = fmaf(S.etot[q], s, S.ds[q * kState + e]);
      }
      if (has_next)
        S.carry[e] = s;
      else if (d < a.Dh && n < a.N)
        a.state_out[((static_cast<size_t>(bb) * a.H + h) * a.Dh + d) * a.N +
                    n] = s;
    }
    __syncthreads();

    // 6. y = exp(incl) (c . S^T) + y_intra, rounded once, stored
    if (band) {
      const float ein[2] = {S.einc[r0 + g], S.einc[r0 + g + 8]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float inter[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = kPlanesS - 1; p >= 0; --p) {  // lo, mid, hi
          const __nv_bfloat16* prow =
              &S.planes[((bq * 3 + p) * kDh + nt * 8 + g) * kLds + 2 * q4];
          mma_bf16(inter, ca, lds32(prow), lds32(prow + 8));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nt][e] = fmaf(ein[e >> 1], inter[e], acc[nt][e]);
      }
      // y through a per-band [16][64] area of `ds` (bands 0-7) or `w`
      // (bands 8-15), free since step 5, 8-value groups xor-swizzled by
      // row; then stored a row at a time, 32 lanes on a row's Dh values
      __nv_bfloat16* ytile =
          (warp < 8 ? reinterpret_cast<__nv_bfloat16*>(S.ds) : S.w) +
          (warp & 7) * 16 * kDh;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<__nv_bfloat162*>(
              &ytile[(g + 8 * half) * kDh + (nt ^ g) * 8 + 2 * q4]) =
              __floats2bfloat162_rn(acc[nt][2 * half],
                                    acc[nt][2 * half + 1]);
      __syncwarp();
      const int rows = min(16, min(G.C - bi * 16, T - band_tok));
      for (int i = 0; i < rows; ++i) {
        __nv_bfloat16* yrow = static_cast<__nv_bfloat16*>(a.y) +
                              ((static_cast<size_t>(bb) * T + band_tok + i) *
                                   a.H + h) * a.Dh;
        if (2 * lane < a.Dh)
          *reinterpret_cast<uint32_t*>(yrow + 2 * lane) =
              *reinterpret_cast<const uint32_t*>(
                  &ytile[i * kDh + ((2 * lane) ^ ((i & 7) << 3))]);
      }
    }

    cp_async_wait_all();
    if (has_next) mbar_wait(&S.full, (st + 1) & 1);
    __syncthreads();
    if (has_next) {
      unpack_tile(S, a, Tile(G, st + 1));
      __syncthreads();
    }
  }
}

// the widths the tensor-core kernel takes (N and Dh zero-padded to kN
// and kDh; Dh even: y is stored in pairs)
bool bf16_tiles_take(const SsdArgs& a) {
  return a.N <= kN && a.Dh <= kDh && a.Dh % 2 == 0;
}

cudaError_t launch_bf16(const SsdArgs& a, cudaStream_t stream) {
  if (!bf16_tiles_take(a)) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(TileSmem));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_bf16_kernel<<<dim3(a.H, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 f32 c/b/v/y on the FMA kernel, 1 bf16 on the tensor-core
// tile kernel (N <= 16, even Dh <= 64; other widths are refused), 2 bf16
// on the FMA kernel. The wrapper picks the variant from the widths.
// Returns a cudaError_t (0 = launched).
extern "C" int flashy_ssd_scan(int variant, const SsdArgs* args,
                               void* stream) {
  SsdArgs a = *args;
  if (a.B < 1 || a.H < 1 || a.T < 1 || a.N < 1 || a.Dh < 1 || a.C < 1 ||
      a.C > kMaxChunk || a.B > 65535 || a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.C > a.T) a.C = a.T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return static_cast<int>(launch_fma<float>(a, s));
    case 1:
      return static_cast<int>(launch_bf16(a, s));
    case 2:
      return static_cast<int>(launch_fma<__nv_bfloat16>(a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
