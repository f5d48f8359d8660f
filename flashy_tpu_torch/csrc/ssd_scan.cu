// SSD chunked scan on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of flashy_tpu/ops/ssd_scan.py:
// `_fused_ssd_body`, launched by `_fused_call`. It computes what that
// body computes. For each (batch b, head h) it walks the chunks of C
// tokens in order and carries the f32 state S [Dh, N] across them; the
// TPU grid's innermost "arbitrary" chunk axis becomes the loop inside
// one thread block. Per chunk of L <= C tokens (the last one may be the
// sub-chunk tail), with la the f32 log-decays:
//   seg[t, s] = sum_{s<r<=t} la_r      decay = exp(seg) on t >= s
//   incl[t]   = sum_{r<=t} la_r        suffix[s] = sum_{r>s} la_r
//   total     = sum_r la_r
//   y[t]      = sum_{s<=t} (c_t.b_s) decay[t, s] v_s + exp(incl[t]) (S c_t)
//   S         = exp(total) S + sum_s v_s (x) b_s exp(suffix[s])
// Every one of those sums is a DIRECT sum in ascending r, never a
// difference of cumulative sums: at a segment reset la = -1e30, which a
// difference would cancel into garbage, while a direct sum holding it
// stays near -1e30 and expf of it is exactly 0. bf16 operands are
// widened to f32, every sum is an f32 FMA chain, and only y is rounded
// to the input dtype, as the TPU body does (`y.astype(y_ref.dtype)`).
//
// Determinism is the contract the serving engine leans on: splitting a
// stream at a chunk multiple and passing the state must give the same
// bits as one call, and a right-padded chunk (b = 0, la = 0 on the pad
// tokens) the same bits as the unpadded tail. Each output is one fixed
// ascending chain of operations on its chunk's data and the incoming
// state alone: no atomics, no reduction whose order depends on the
// launch, and pad terms that enter at the end of a chain as exact
// zeros. seg[t, s] is recomputed from s+1 up by each thread that needs
// it, which gives the same bits as any running sum along t.
//
// What bounds it on this card: the function is bound by bytes. At the
// serving widths (H 16, Dh 64, N 16, C 64, bf16) a token brings
// (2N + Dh) x 2 + 4 = 196 bytes in and takes Dh x 2 = 128 out, and its
// four products cost ~9.3k flops (the causal halves over ~C/2 keys,
// plus 4 N Dh): ~29 flops a byte, far below the ~295 at which the
// tensor cores would be the limit. This kernel is bound by neither: a
// prefill slice is one [1, 64] chunk per head, so the grid is small and
// each block's work is chains of dependent FMAs on shared memory, and
// at a long prompt the chunks of one (b, h) run one after another. The
// design's answer is only to spread the work: each block owns a group
// of 16 of the Dh state rows (recomputing the scores, which every group
// needs), so the grid is (Dh / 16, H, B); the scores are built in tiles
// of 64 query rows (a [256, 256] f32 score matrix, 256 KB, would not
// fit a block's 227 KB), with the key columns split over the threads
// and each column's rows split further while threads are spare. Tensor
// cores for the four products, and several chunks in flight with only
// the state chained, are later work (ROADMAP.md queue B); this version
// is plain f32 FMAs from shared memory. Its times beside its bound are
// in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;
constexpr int kRowTile = 64;         // query rows of scores held at once
constexpr int kGroup = 16;           // state rows (of Dh) per block
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// DT: dtype of c, b, v and y. Grid: (Dh / G, H, B). Layouts: c, b
// [B, H, T, N]; v, y [B, H, T, Dh]; la [B, H, T]; state_in, state_out
// [B, H, Dh, N].
template <typename DT>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const DT* __restrict__ c, const DT* __restrict__ b,
                const DT* __restrict__ v, const float* __restrict__ la,
                const float* __restrict__ state_in, DT* __restrict__ y,
                float* __restrict__ state_out, int H, int T, int N, int Dh,
                int C, int G) {
  const int d0 = blockIdx.x * G;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const int tid = threadIdx.x;
  const int ldn = N + 1;   // padded rows: no bank conflicts across tokens
  const int ldp = C + 1;
  const int R = min(kRowTile, C);

  extern __shared__ float smem[];
  float* c_s = smem;                // [C][ldn]
  float* b_s = c_s + C * ldn;       // [C][ldn]; later b * exp(suffix)
  float* v_s = b_s + C * ldn;       // [C][G] this block's state rows
  float* st_s = v_s + C * G;        // [G][ldn] the carried state rows
  float* la_s = st_s + G * ldn;     // [C]
  float* ein_s = la_s + C;          // [C] exp(incl)
  float* esu_s = ein_s + C;         // [C] exp(suffix)
  float* p_s = esu_s + C;           // [R][ldp] scores x decay
  __shared__ float etot;            // exp(total)

  const DT* cg = c + bh * T * N;
  const DT* bg = b + bh * T * N;
  const DT* vg = v + bh * T * Dh;
  const float* lag = la + bh * T;
  DT* yg = y + bh * T * Dh;

  for (int i = tid; i < G * N; i += kThreads) {
    const int d = i / N, n = i - d * N;
    st_s[d * ldn + n] = state_in[(bh * Dh + d0 + d) * N + n];
  }

  for (int base = 0; base < T; base += C) {
    const int L = min(C, T - base);
    __syncthreads();  // the previous chunk is done with the tiles
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      const size_t src = static_cast<size_t>(base + t) * N + n;
      c_s[t * ldn + n] = to_float(cg[src]);
      b_s[t * ldn + n] = to_float(bg[src]);
    }
    for (int i = tid; i < L * G; i += kThreads) {
      const int t = i / G, d = i - t * G;
      const size_t src = static_cast<size_t>(base + t) * Dh + d0 + d;
      v_s[t * G + d] = to_float(vg[src]);
    }
    for (int t = tid; t < L; t += kThreads) la_s[t] = lag[base + t];
    __syncthreads();

    for (int t = tid; t < L; t += kThreads) {
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
    __syncthreads();

    for (int r0 = 0; r0 < L; r0 += R) {
      const int rows = min(R, L - r0);
      // scores x decay of query rows r0.. against key columns s <= t:
      // one thread per (column, slice of the tile's rows)
      const int cols = r0 + rows;
      const int slices = max(1, kThreads / cols);
      const int per = (rows + slices - 1) / slices;
      for (int i = tid; i < cols * slices; i += kThreads) {
        const int s = i % cols, q = i / cols;
        const int lo = max(r0 + q * per, s);
        const int hi = min(r0 + (q + 1) * per, r0 + rows);
        if (lo >= hi) continue;
        float seg = 0.f;
        for (int r = s + 1; r <= lo; ++r) seg += la_s[r];
        for (int t = lo; t < hi; ++t) {
          if (t > lo) seg += la_s[t];
          float dot = 0.f;
          for (int n = 0; n < N; ++n)
            dot = fmaf(c_s[t * ldn + n], b_s[s * ldn + n], dot);
          p_s[(t - r0) * ldp + s] = dot * expf(seg);
        }
      }
      __syncthreads();
      for (int i = tid; i < rows * G; i += kThreads) {
        const int t = r0 + i / G, d = i % G;
        const float* p_row = p_s + (t - r0) * ldp;
        float intra = 0.f, inter = 0.f;
        for (int s = 0; s <= t; ++s)
          intra = fmaf(p_row[s], v_s[s * G + d], intra);
        for (int n = 0; n < N; ++n)
          inter = fmaf(c_s[t * ldn + n], st_s[d * ldn + n], inter);
        yg[static_cast<size_t>(base + t) * Dh + d0 + d] =
            from_float<DT>(intra + ein_s[t] * inter);
      }
      __syncthreads();
    }

    // S = exp(total) S + v^T (b exp(suffix)), after every row of the
    // chunk has read the incoming S
    for (int i = tid; i < L * N; i += kThreads) {
      const int s = i / N, n = i - s * N;
      b_s[s * ldn + n] *= esu_s[s];
    }
    __syncthreads();
    for (int i = tid; i < G * N; i += kThreads) {
      const int d = i / N, n = i - d * N;
      float acc = 0.f;
      for (int s = 0; s < L; ++s)
        acc = fmaf(v_s[s * G + d], b_s[s * ldn + n], acc);
      st_s[d * ldn + n] = etot * st_s[d * ldn + n] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * N; i += kThreads) {
    const int d = i / N, n = i - d * N;
    state_out[(bh * Dh + d0 + d) * N + n] = st_s[d * ldn + n];
  }
}

template <typename DT>
cudaError_t launch(const void* c, const void* b, const void* v,
                   const float* la, const float* state_in, void* y,
                   float* state_out, int B, int H, int T, int N, int Dh,
                   int C, cudaStream_t stream) {
  const int G = Dh % kGroup == 0 ? kGroup : Dh;
  const int R = C < kRowTile ? C : kRowTile;
  const size_t floats = 2 * static_cast<size_t>(C) * (N + 1) +
                        static_cast<size_t>(C) * G +
                        static_cast<size_t>(G) * (N + 1) + 3 * C +
                        static_cast<size_t>(R) * (C + 1);
  const size_t smem = floats * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ssd_scan_kernel<DT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(Dh / G, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const DT*>(c), static_cast<const DT*>(b),
      static_cast<const DT*>(v), la, state_in, static_cast<DT*>(y),
      state_out, H, T, N, Dh, C, G);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 f32 c/b/v/y, 1 bf16. Returns a cudaError_t (0 = launched).
extern "C" int flashy_ssd_scan(int variant, const void* c, const void* b,
                               const void* v, const void* la,
                               const void* state_in, void* y,
                               void* state_out, int B, int H, int T, int N,
                               int Dh, int C, void* stream) {
  if (B < 1 || H < 1 || T < 1 || N < 1 || Dh < 1 || C < 1 ||
      C > kMaxChunk || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C > T) C = T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la_f = static_cast<const float*>(la);
  const float* st_in = static_cast<const float*>(state_in);
  float* st_out = static_cast<float*>(state_out);
  switch (variant) {
    case 0:
      return launch<float>(c, b, v, la_f, st_in, y, st_out, B, H, T, N, Dh,
                           C, s);
    case 1:
      return launch<__nv_bfloat16>(c, b, v, la_f, st_in, y, st_out, B, H, T,
                                   N, Dh, C, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
