// Dense batched GPR negative log marginal likelihood for Hopper: factor,
// forward solve and log-determinant of a prebuilt K + sigma^2 I, optionally
// with W = L^{-1}.
//
// Replaces the TPU kernels of portfoliooptgp_tpu/ops/pallas/nll.py:
//   _nll_kernel      (factor + solve + log-det; the primal of batched_nll,
//                     through batched_nll_pallas and _factor_solve)
//   _nll_inv_kernel  (the same plus W = L^{-1}; the VJP forward, through
//                     _factor_solve_inv)
// They serve the router's `pallas_dense` tier: kernels the fused tier cannot
// build (a Polynomial atom, a sum nested in a product, ...) at padded
// N <= 256. One source, the inverse a template flag.
//
// For every model b (one CTA each):
//   L L^T = K_b + s_b I,  a = L^{-1} y_b,  logdet_b = sum log diag L,
//   optionally W_b = L^{-1},
//   nll_b = 1/2 |a|^2 + logdet_b + 1/2 N log 2 pi.
// Only the lower triangle of K_b (i >= j) is read, through K's strides. An
// indefinite pivot gives sqrt of a negative number: NaN, never a clamp or
// jitter, so the line search rejects the step as on the TPU. From the first
// indefinite pivot k, a[k:] and the log-det are NaN and W[i][c] is NaN
// exactly for i >= k, c <= i, as in the column loop of the plain version;
// W's zeros above the diagonal are written, never computed. The TPU kernel
// pads N to 128 with an identity tail and B to 8; here any N up to 256 and
// any B are taken, and the 2 pi constant is the real N's.
//
// Design. N is padded to Np = 32 T (T <= 8 tiles) with an identity block,
// which factors to itself and never reaches a real entry, the log-det or
// the 2 pi constant. The lower triangle of K_b + s_b I lives in shared memory
// as T (T + 1) / 2 tiles of 32 x 32, and is factored right-looking in
// 32-column sub-panels, as the TPU kernel's nll._blocked_chol does with
// 64-column ones, by the steps of csrc/blocked_panel.cu (chol_tile.cuh; the
// tile steps and the inverse are in nll_tile.cuh, which csrc/stationary_nll.cu
// shares):
//   (a) one warp factors the diagonal tile in registers, a row per lane;
//   (b) a thread per row below solves that row against the 32 x 32 factor;
//       y rides along as one more row, so a = L^{-1} y needs no loop of its
//       own;
//   (c) the tiles of the trailing matrix take the rank-32 update on 4 x 4
//       register micro-tiles (a warp per half tile), and y's row its
//       32-term products.
// Three barriers a sub-panel, 24 at N = 256, where a column-at-a-time loop
// takes three a column, 768. (Look-ahead, the next diagonal tile's update
// and factor beside the rest of (c), was tried: it helped only the
// value-only kernel at N = 256, and its registers slowed the inverse.)
//
// With the flag, W is formed once the factor is done, by the substitution of
// csrc/trinv.cu: a thread owns a column c of W and computes it row block by
// row block (J = 0 .. T-1, all columns in step): the products with the
// earlier row blocks of its column, then the solve against the diagonal
// tile, the division last, the terms in the substitution's own order and
// the structural zeros skipped by predicates (never multiplied, so NaN * 0
// never lands where the plain version has 0). Row block J of W then replaces
// row block J of L in place (the factor is done with it) and goes out to
// global memory in coalesced rows, once: W is never read back from global
// memory. Two barriers a row block. The unrolled product and solve are
// large, so each has one call site: copies specialised for the masked and
// the unmasked case were slower (instruction fetch). Running the inverse's
// row blocks beside the factor's steps was tried too: the factoring warp's
// pivot chain slowed more than the overlap saved (tools/kernel_timeline.py).
// Column tile 0's warp does the most work.
//
// Rounding is the JAX kernel's: pivots d = sqrt(p) and quotients x / d from
// one rsqrt estimate and one correction each (chol_tile.cuh: correctly
// rounded but within ~1e-14 of a tie), never a raw estimate or a
// reciprocal multiply. Sums of a sub-panel's 32 terms are formed first and
// then subtracted, as the TPU kernel's boundary products are.
//
// Card features.
// - Shared memory: a tile row is 36 floats (9 float4s, odd), so the row
//   per lane of (a), (b) and the inverse's writes, and the 8 rows of a
//   quarter warp in (c), fall in distinct banks; (c)'s column quads, the
//   inverse's rows of L and the solves' columns of L are warp-wide
//   broadcasts. The solves read the diagonal tiles transposed (32 x 32
//   each, written by the factoring warp; one buffer without W). At
//   N = 256: 36 tiles (165,888 B), the transposes (32,768 B with W, 4,096
//   without) and 7,296 B of vectors: 205,952 B with W and 177,280 B
//   without; at N = 77 (T = 3) 45,312 B with W. The launch raises the
//   kernel's dynamic shared-memory limit once.
// - Registers: the unrolled 32-row solves and products take 255 a thread
//   (a few dozen bytes of spills), so one 256-thread CTA an SM at every N;
//   B = 128 is one wave on 132 SMs.
// - Asynchronous copies: the lower tiles are staged by 4-byte cp.async
//   (hopper_async.cuh; K may be any strided view, odd row strides
//   included), tile column 0 first, so that step 0's (a) and (b) run while
//   the rest lands; each thread adds s_b to the diagonal entries it copied
//   once they land, where a plain load of each stalled its warp.
// - Tensor cores: not used. The port keeps fp32 at full precision (TF32 is
//   off; the JAX package pins HIGHEST because the factor went indefinite at
//   single-pass precision), and a tile product would multiply the
//   structural zeros of the triangles, which breaks the exact NaN pattern.
//
// Bound on an H100 (SXM, 700 W): per model N^3/3 flops of factor (+ N^3/3
// of inverse). At B = 128, N = 256 with W: 1.4 GFLOP of fp32 (~21 us at
// 67 TFLOP/s) against 17 MB of K read and 34 MB of W written (~15 us at
// 3.35 TB/s): operations bound. At the multi-input shapes (B = 1..20,
// N = 72..77) a few CTAs occupy a few of the 132 SMs, and the time is the
// latency of the chain: three warp factors of 32 dependent pivots, their
// row solves, and the last row blocks of the inverse
// (tools/kernel_timeline.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "chol_tile.cuh"
#include "hopper_async.cuh"
#include "nll_tile.cuh"

#define THREADS 256
#define MAX_N 256            // the routing window's padded N (nll.MAX_PALLAS_N)

// Stage the tiles of tile columns [s_begin, s_end): the lower triangle by
// cp.async, zeros above the diagonal and the padding rows' identity by plain
// stores. Warp w copies rows r = w, w + 8, ... of each tile column, lane l
// its column l: so diagonal entry (r, r) of a tile is copied by lane r of
// warp r % 8 (add_noise).
__device__ __forceinline__ void stage(float* tiles, const float* Kb, long long sr, long long sc,
                                      int N, int T, int s_begin, int s_end) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int S = s_begin; S < s_end; ++S) {
    const int j = SP * S + lane;
    for (int t = warp; t < SP * (T - S); t += THREADS / 32) {
      const int R = S + t / SP, r = t % SP, i = SP * R + r;
      float* dst = tiles + tile_index(R, S) * TILE + r * LDT + lane;
      const float* src = Kb + (long long)i * sr + (long long)j * sc;
      if (i >= N)
        *dst = i == j ? 1.0f : 0.0f;
      else if (j > i)
        *dst = 0.0f;
      else
        cp_async_f32(dst, src);
    }
  }
}

// Add s_b to the diagonal entries of the diagonal tiles [s_begin, s_end) that
// this thread copied, once its own copies have landed (a plain load of each
// would stall its warp for a memory round trip): K_ii + s_b, rounded once,
// before any update, as the plain version forms it.
__device__ __forceinline__ void add_noise(float* tiles, float nz, int N, int s_begin,
                                          int s_end) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane % (THREADS / 32) != warp) return;
  for (int S = s_begin; S < s_end && SP * S + lane < N; ++S)
    tiles[tile_index(S, S) * TILE + lane * LDT + lane] += nz;
}

template <bool WITH_W>
__global__ void __launch_bounds__(THREADS, 1) dense_nll_kernel(
    const float* __restrict__ K,      // (B, N, N), strides (sb, sr, sc)
    long long sb, long long sr, long long sc,
    const float* __restrict__ y,      // (B, N), contiguous
    const float* __restrict__ noise,  // (B,)
    float* __restrict__ nll,          // (B,)
    float* __restrict__ logdet_out,   // (B,)
    float* __restrict__ a_out,        // (B, N)
    float* __restrict__ W,            // (B, N, N) when WITH_W
    int N) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = (N + SP - 1) / SP, Np = SP * T;

  float* tiles = smem;                            // T (T + 1) / 2 tiles of L, then of W
  float* LT = tiles + T * (T + 1) / 2 * TILE;     // the diagonal tiles of L transposed
  float* ay = LT + (WITH_W ? T : 1) * SP * SP;    // Np: y, then a = L^{-1} y
  float* dg = ay + Np;                            // Np: diag L
  float* yd = dg + Np;                            // Np: the estimates of 1 / diag L
  float* lt = yd + Np;                            // SP x SP: (a)'s scratch
  float* red = lt + SP * SP;                      // 32: block reduction
  const float* Kb = K + (size_t)b * sb;
  // Without W one transpose buffer serves every step: step k's is read in
  // (b) before step k + 1's is written.
  auto Lt = [&](int k) { return LT + (WITH_W ? k : 0) * SP * SP; };

  stage(tiles, Kb, sr, sc, N, T, 0, 1);
  cp_async_commit();
  stage(tiles, Kb, sr, sc, N, T, 1, T);
  cp_async_commit();
  const float nz = noise[b];
  for (int i = tid; i < Np; i += THREADS) ay[i] = i < N ? y[(size_t)b * N + i] : 0.0f;
  cp_async_wait<1>();  // tile column 0; the rest lands during (a) and (b) of step 0
  add_noise(tiles, nz, N, 0, 1);
  __syncthreads();

  // The factor, a = L^{-1} y and the log-det, one 32-column sub-panel a
  // step, three phases and three barriers a step.
  float ld = 0.0f;  // sum log diag L, kept by warp 0
  for (int k = 0; k < T; ++k) {
    const int base = SP * (k + 1);  // the first row and column after the sub-panel
    if (warp == 0) factor_step(tiles, Lt(k), dg, yd, lt, k, N, ld);  // (a)
    __syncthreads();

    {  // (b): the rows below the sub-panel and y's row, a thread each
      const int i = base + tid;
      float* row = i < Np ? tiles + tile_index(i / SP, k) * TILE + (i % SP) * LDT
                          : ay + SP * k;
      if (i <= Np) {
        float r[SP];
        load_row(r, row);
        solve(r, Lt(k), dg + SP * k, yd + SP * k, 0);
        store_row(row, r);
      }
    }
    if (k == 0) {  // the later tile columns, before (c) reads them
      cp_async_wait<0>();
      add_noise(tiles, nz, N, 1, T);
    }
    __syncthreads();

    // (c): two units a tile pair (R, S), k < S <= R, enumerated row by row,
    // then y's row.
    const int n = T - k - 1, units = n * (n + 1) + 1;
    for (int u = warp; u < units; u += THREADS / 32) {
      if (u == units - 1) {  // a[j] -= sum_m a[32 k + m] L(j, 32 k + m), j >= base
        const float4* ak = reinterpret_cast<const float4*>(ay + SP * k);
        for (int j = base + lane; j < Np; j += 32) {
          const float4* Lj = reinterpret_cast<const float4*>(
              tiles + tile_index(j / SP, k) * TILE + (j % SP) * LDT);
          float s = 0.0f;
#pragma unroll
          for (int q = 0; q < SP / 4; ++q) {
            const float4 v = Lj[q], w = ak[q];
            s = fmaf(v.x, w.x, s);
            s = fmaf(v.y, w.y, s);
            s = fmaf(v.z, w.z, s);
            s = fmaf(v.w, w.w, s);
          }
          ay[j] -= s;
        }
        continue;
      }
      int p = u >> 1, r = 0;
      while (p > r) p -= ++r;  // pair p -> (row r, column p) of the trailing tiles
      const int R = k + 1 + r, S = k + 1 + p;
      update_half(tiles + tile_index(R, S) * TILE, tiles + tile_index(R, k) * TILE,
                  tiles + tile_index(S, k) * TILE, u & 1);
    }
    __syncthreads();
  }

  // W = L^{-1} (form_inverse, nll_tile.cuh).
  if (WITH_W) form_inverse(tiles, Lt, dg, yd, W + (size_t)b * N * N, N, T);

  // a, the log-det and nll = 1/2 |a|^2 + logdet + 1/2 N log 2 pi.
  float quad = 0.0f;
  for (int i = tid; i < N; i += THREADS) {
    const float ai = ay[i];
    a_out[(size_t)b * N + i] = ai;
    quad += ai * ai;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) quad += __shfl_xor_sync(FULL, quad, o);
  if (lane == 0) red[warp] = quad;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) total += red[w];
    logdet_out[b] = ld;
    nll[b] = 0.5f * total + ld + (float)(0.5 * N * 1.8378770664093453);
  }
}

template <bool WITH_W>
static cudaError_t configure() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(dense_nll_kernel<WITH_W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)(smem_floats(MAX_N, WITH_W) * sizeof(float)));
  if (e == cudaSuccess) configured = true;
  return e;
}

template <bool WITH_W>
static cudaError_t launch(const float* K, long long sb, long long sr, long long sc,
                          const float* y, const float* noise, float* nll, float* logdet,
                          float* a, float* W, int B, int N, cudaStream_t stream) {
  cudaError_t e = configure<WITH_W>();
  if (e != cudaSuccess) return e;
  dense_nll_kernel<WITH_W><<<B, THREADS, smem_floats(N, WITH_W) * sizeof(float), stream>>>(
      K, sb, sr, sc, y, noise, nll, logdet, a, W, N);
  return cudaGetLastError();
}

// Plain C entry point: every pointer is a device pointer; W null for the
// value-only kernel. Returns the cudaError_t of the launch.
extern "C" int dense_nll_launch(const float* K, long long sb, long long sr, long long sc,
                                const float* y, const float* noise, float* nll,
                                float* logdet, float* a, float* W, int B, int N,
                                void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (N > MAX_N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = W ? launch<true>(K, sb, sr, sc, y, noise, nll, logdet, a, W, B, N, s)
                    : launch<false>(K, sb, sr, sc, y, noise, nll, logdet, a, W, B, N, s);
  return (int)e;
}

// CTAs of the kernel resident on one SM at once at this N (occupancy), or
// -1 on error.
extern "C" int dense_nll_ctas_per_sm(int N, int with_w) {
  if (N <= 0 || N > MAX_N) return -1;
  int n = -1;
  const size_t bytes = smem_floats(N, with_w) * sizeof(float);
  cudaError_t e = with_w ? configure<true>() : configure<false>();
  if (e != cudaSuccess) return -1;
  e = with_w ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dense_nll_kernel<true>, THREADS,
                                                             bytes)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dense_nll_kernel<false>,
                                                             THREADS, bytes);
  return e == cudaSuccess ? n : -1;
}
