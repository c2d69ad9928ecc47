// The batch phase of the Gaussian SVGP ELBO for Hopper: one forward and one
// backward kernel, each one launch that spreads the minibatch over the card
// and reduces across its CTAs inside the kernel, in a fixed order.
//
// Replaces the TPU kernels of portfoliooptgp_tpu/ops/pallas/svgp_gram.py:
//   _fwd_kernel  (Kuf, m = t^T Kuf, G = (Kuf o w) Kuf^T, sq = sum w (y - m)^2)
//   _bwd_kernel  (t-bar, v-bar, s-bar, Z-bar, y-bar in closed form from
//                 G-bar and sq-bar, Kuf rebuilt)
// reached through svgp.gaussian_elbo_gram_fused(use_pallas=True).
//
// Forward, for rows b of X (B, D), inducing points m of Z (M, D):
//   u[m,b] = sum_d s_d (Z[m,d] - X[b,d])^2   (by differences, never through
//            |z|^2 + |x|^2 - 2zx: at day coordinates up to 16,060 and
//            l = 300 that loses ~2e-4 of u in fp32)
//   K[m,b] = v phi(u),  e_b = y_b - sum_m t_m K[m,b]
//   G = sum_b w_b K[:,b] K[:,b]^T,  sq = sum_b w_b e_b^2
// Backward, from G-bar and sq-bar, with H = G-bar + G-bar^T and we = w e:
//   Kbar[m,b] = w_b (H K)[m,b] - 2 sqbar t_m we_b,  W2 = Kbar v phi'(u)
//   t-bar_m = -2 sqbar sum_b we_b K[m,b],  y-bar_b = 2 sqbar we_b,
//   v-bar = sum Kbar phi,  Z-bar[m,d] = 2 s_d sum_b W2[m,b] (Z[m,d] - X[b,d]),
//   s-bar_d = sum_{m,b} W2[m,b] (Z[m,d] - X[b,d])^2
// Rows with w = 0 (the iterator's padding) contribute exactly 0 to every sum.
// The TPU kernel pads D to 128 lanes and B to 128; nothing is padded here.
//
// What bounds it. At the benchmark shape (M, B, D) = (128, 2048, 1) the
// forward's lower triangle of G is 34 MFLOP (~0.5 us at 67 TFLOP/s of fp32)
// and the backward's H Kuf 67 MFLOP (~1.1 us); both move ~0.1 MB. That work
// fills the card only if it is spread over ~130 SMs, and then each CTA's
// share is a few thousand cycles: the latency of its chain (stage, build
// Kuf, product, reduce across CTAs) sets the time, not the FMAs, and the
// build's phi (an expf per entry, Kuf rebuilt by every unit that needs it)
// costs more issue slots than the products.
//
// Design. Both grids are (C, U): U units of work, each split over C CTAs
// (ranks) that take C chunks of the batch's columns; the wrapper's
// launch_shape(M, B, D) picks C (at most 16, C U at most 132) and the chunk
// from the shape alone, so a given input always rounds the same way. A CTA
// walks its chunk in passes of STAGE columns with Z, X, w, y and t staged
// in shared memory (the next pass's columns loaded into registers during
// the current one) and Kuf built there, eight to thirty-two independent phi
// in flight a thread. A unit's C partials meet through the scratch: each
// CTA writes its own, takes an integer arrival ticket, and the last to
// arrive sums the C partials in rank order and resets the ticket (gather).
// No float atomics: reruns agree bit for bit. No clusters: a cluster's CTAs
// share one GPC, and on an H100 11 clusters of 12 ran on 100 SMs, two CTAs
// on some, where a plain grid of 132 CTAs gets one an SM (PERF.md, PR 13).
// - Forward: unit 0 takes sq (whole columns of Kuf, m = t^T Kuf); each
//   other unit owns a 32 x 32 block (I, J), I >= J, of G's lower triangle.
//   A warp takes every eighth column of a pass and accumulates the whole
//   block in an 8 x 4 register tile a lane (32 FMAs per three broadcast
//   float4 loads); the warps' tiles are summed in shared memory, the unit's
//   CTAs' through the scratch, and the block is written to both triangles
//   of G, so G is exactly symmetric.
// - Backward: unit P owns 16 rows of H Kuf. It stages H's rows as it reads
//   them (G-bar[p,k] + G-bar[k,p], no separate symmetrize) for 128 (or 64)
//   k at a time, builds those rows of Kuf for the pass (m = t^T Kuf on the
//   side), and a warp accumulates 16 rows x 64 columns over a quarter of
//   the k (8 x 4 a lane), the quarters summed in shared memory. The
//   epilogue takes phi and phi' from one expf per entry, writes W2 to
//   shared memory, and every warp then takes two rows for Z-bar and s-bar
//   with shuffles. Rows are final after the unit's gather (t-bar, Z-bar);
//   v-bar and s-bar span units, so the last unit to finish gathers the U
//   units' through a second ticket.
// Everything is plain fp32 (no TF32), the counterpart of the TPU kernel's
// Precision.HIGHEST.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define STAGE 128     // columns of X per pass of a CTA
#define FWD_BLOCK 32  // G in 32 x 32 blocks
#define BWD_ROWS 16   // rows of H Kuf per backward CTA
#define MAX_RANKS 16  // CTAs a unit splits the batch over
#define MAX_D 128
#define FULL 0xffffffffu

enum Family { FAM_SE = 0, FAM_MATERN12 = 1, FAM_MATERN32 = 2, FAM_MATERN52 = 3 };

// phi and d phi / du from one expf; mirror stationary_nll._phi and
// _phi_prime (the matern12 derivative is masked to 0 at u <= 1e-12, where it
// is singular).
__device__ __forceinline__ void phi_both(int fam, float u, float& f, float& fp) {
  const float SQRT3 = 1.7320508075688772f;
  const float SQRT5 = 2.23606797749979f;
  if (fam == FAM_SE) {
    const float e = expf(-0.5f * u);
    f = e;
    fp = -0.5f * e;
    return;
  }
  const float r = sqrtf(fmaxf(u, 0.0f));
  if (fam == FAM_MATERN12) {
    const float e = expf(-r);
    f = e;
    fp = u > 1e-12f ? -e / (2.0f * r) : 0.0f;
    return;
  }
  if (fam == FAM_MATERN32) {
    const float e = expf(-SQRT3 * r);
    f = (1.0f + SQRT3 * r) * e;
    fp = -1.5f * e;
    return;
  }
  const float e = expf(-SQRT5 * r);
  f = (1.0f + SQRT5 * r + (5.0f / 3.0f) * u) * e;
  fp = -(5.0f / 6.0f) * (1.0f + SQRT5 * r) * e;
}

__device__ __forceinline__ float phi(int fam, float u) {
  float f, fp;
  phi_both(fam, u, f, fp);
  return f;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Sum of x over the block; every thread gets it. `red` holds 32 floats.
__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < WARPS ? red[lane] : 0.0f;
  return warp_sum(x);
}

// A unit's C CTAs each hold a partial of n floats in shared memory (`part`).
// Each writes it to its slot of `slots` (C x n floats), and an integer
// arrival ticket picks the last CTA to arrive, which sums the C slots in
// rank order into its `part` (no float atomics: the sum does not depend on
// who arrives last) and resets the ticket to 0 for the next launch. Returns
// true, the same in every thread, in that CTA only. With C = 1 nothing is
// exchanged. `flag` is one int of shared memory.
__device__ bool gather(float* part, int n, float* slots, unsigned* ticket, int rank, int C,
                       int* flag) {
  if (C == 1) return true;
  const int tid = threadIdx.x;
  float* mine = slots + (size_t)rank * n;
  for (int i = tid; i < n; i += THREADS) mine[i] = part[i];
  __threadfence();  // the slot is visible before the ticket is
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(ticket, 1u) == (unsigned)(C - 1);
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  for (int i = tid; i < n; i += THREADS) {
    float a = 0.0f;
    for (int q0 = 0; q0 < C; q0 += MAX_RANKS) {
      float v[MAX_RANKS];  // every slot's load in flight at once
#pragma unroll
      for (int q = 0; q < MAX_RANKS; ++q)
        v[q] = q0 + q < C ? __ldcg(slots + (size_t)(q0 + q) * n + i) : 0.0f;
#pragma unroll
      for (int q = 0; q < MAX_RANKS; ++q) a += v[q];
    }
    part[i] = a;
  }
  if (tid == 0) *ticket = 0u;
  __syncthreads();
  return true;
}

// u between staged row r of zT (transposed: zT[d * zs + r]) and staged
// column j of xs (xs[d * STAGE + j]). DC = 1: D is 1 at compile time (the
// SVGP path); DC = 0: D from the argument.
template <int DC>
__device__ __forceinline__ float u_at(const float* zT, int zs, int r, const float* xs, int j,
                                      const float* sS, int D) {
  const int Dk = DC ? DC : D;
  float u = 0.0f;
  for (int d = 0; d < Dk; ++d) {
    const float diff = zT[d * zs + r] - xs[d * STAGE + j];
    u += sS[d] * (diff * diff);
  }
  return u;
}

// Stage rows r0 .. r0 + n - 1 of Z transposed (zT[d * n + r]), 0 past M.
template <int DC>
__device__ void stage_rows(float* zT, const float* __restrict__ Z, int r0, int n, int M, int D) {
  const int Dk = DC ? DC : D;
  for (int i = threadIdx.x; i < n * Dk; i += THREADS) {
    const int d = i / n, r = i - d * n;
    zT[i] = r0 + r < M ? Z[(size_t)(r0 + r) * Dk + d] : 0.0f;
  }
}

// A pass's columns c0 .. c0 + nc - 1: X transposed (xs[d * STAGE + j]), w
// and (if ys) y, 0 past nc. With D = 1 a thread loads its column into
// registers (`load`) while the previous pass computes and stores it at the
// start of the next (`store`); otherwise stage_columns loads and stores at
// once.
struct Columns {
  float x, w, y;

  __device__ __forceinline__ void load(const float* __restrict__ X, const float* __restrict__ wp,
                                       const float* __restrict__ yp, int c0, int nc) {
    const int j = threadIdx.x;
    x = w = y = 0.0f;
    if (j < STAGE && j < nc) {
      x = X[c0 + j];
      w = wp[c0 + j];
      if (yp) y = yp[c0 + j];
    }
  }

  __device__ __forceinline__ void store(float* xs, float* ws, float* ys) const {
    const int j = threadIdx.x;
    if (j < STAGE) {
      xs[j] = x;
      ws[j] = w;
      if (ys) ys[j] = y;
    }
  }
};

__device__ void stage_columns(float* xs, float* ws, float* ys, const float* __restrict__ X,
                              const float* __restrict__ w, const float* __restrict__ y, int c0,
                              int nc, int D) {
  for (int i = threadIdx.x; i < STAGE * D; i += THREADS) {
    const int d = i / STAGE, j = i - d * STAGE;
    xs[i] = j < nc ? X[(size_t)(c0 + j) * D + d] : 0.0f;
  }
  for (int j = threadIdx.x; j < STAGE; j += THREADS) {
    ws[j] = j < nc ? w[c0 + j] : 0.0f;
    if (ys) ys[j] = j < nc ? y[c0 + j] : 0.0f;
  }
}

// The pass at c0 into xs, ws, ys: from the registers loaded during the
// previous pass (D = 1), or from global memory.
template <int DC>
__device__ __forceinline__ void put_columns(const Columns& next, float* xs, float* ws, float* ys,
                                            const float* __restrict__ X,
                                            const float* __restrict__ w,
                                            const float* __restrict__ y, int c0, int nc, int D) {
  if (DC == 1) next.store(xs, ws, ys);
  else stage_columns(xs, ws, ys, X, w, y, c0, nc, D);
}

// -- the forward ------------------------------------------------------------

// Shared memory in floats: kI, kw (STAGE x 32 each; the warps' G tiles alias
// them at the end, the sq unit stages rows of Z and t there), part (32 x 32),
// zI, zJ (32 x D), xs (D x STAGE), ws, ys (STAGE), sS (D), red (32), flag (1).
__host__ __device__ inline int fwd_smem_floats(int D) {
  return 2 * STAGE * FWD_BLOCK + FWD_BLOCK * FWD_BLOCK + 2 * FWD_BLOCK * D + STAGE * D +
         2 * STAGE + D + 32 + 1;
}

// Rows of Z (with t) the sq unit stages at once in kI and kw: a multiple of
// 16, all of M when it fits.
__device__ __forceinline__ int sq_rows(int M, int D) {
  const int most = (2 * STAGE * FWD_BLOCK / (D + 1)) & ~15;
  return min(most, (M + 15) & ~15);
}

template <int DC>
__global__ void __launch_bounds__(THREADS, 2) gram_fwd_kernel(
    const float* __restrict__ Z, const float* __restrict__ X, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ t, const float* __restrict__ vp,
    const float* __restrict__ s, int ns, float* __restrict__ G, float* __restrict__ sq,
    float* __restrict__ scratch, unsigned* __restrict__ tickets, int M, int B, int D, int chunk,
    int fam) {
  extern __shared__ float4 smem4[];
  const int Dk = DC ? DC : D;
  float* kI = reinterpret_cast<float*>(smem4);
  float* kw = kI + STAGE * FWD_BLOCK;
  float* part = kw + STAGE * FWD_BLOCK;
  float* zI = part + FWD_BLOCK * FWD_BLOCK;
  float* zJ = zI + FWD_BLOCK * Dk;
  float* xs = zJ + FWD_BLOCK * Dk;
  float* ws = xs + STAGE * Dk;
  float* ys = ws + STAGE;
  float* sS = ys + STAGE;
  float* red = sS + Dk;
  int* flag = reinterpret_cast<int*>(red + 32);

  const int C = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit = blockIdx.y;
  float* slots = scratch + (size_t)unit * C * FWD_BLOCK * FWD_BLOCK;  // the unit's C partials
  const int b0 = rank * chunk, b1 = min(B, b0 + chunk);
  const float v = vp[0];
  for (int d = tid; d < Dk; d += THREADS) sS[d] = s[ns == 1 ? 0 : d];
  Columns next;
  if (DC == 1) next.load(X, w, y, b0, min(STAGE, b1 - b0));

  if (unit == 0) {
    // sq, the heaviest unit, first: whole columns of Kuf, m = t^T Kuf by two threads a column (rows
    // alternating), eight rows' phi in flight, then sum w e^2.
    const int RB = sq_rows(M, Dk);
    float* zq = kI;            // zq[d * RB + r]
    float* tq = kI + Dk * RB;  // t of the staged rows
    auto stage = [&](int m0) {
      stage_rows<DC>(zq, Z, m0, RB, M, Dk);
      for (int r = tid; r < RB; r += THREADS) tq[r] = m0 + r < M ? t[m0 + r] : 0.0f;
    };
    if (M <= RB) stage(0);  // all of M fits: staged once, with the first columns
    const int j = tid & (STAGE - 1), h = tid >> 7;
    float sqp = 0.0f;
    for (int c0 = b0; c0 < b1; c0 += STAGE) {
      const int nc = min(STAGE, b1 - c0);
      __syncthreads();  // the previous pass is done with xs, ws, ys and part
      put_columns<DC>(next, xs, ws, ys, X, w, y, c0, nc, Dk);
      float p = 0.0f;
      for (int m0 = 0; m0 < M; m0 += RB) {
        if (M > RB) {
          if (m0 > 0) __syncthreads();  // the previous rows' readers are done
          stage(m0);
        }
        __syncthreads();
        if (DC == 1 && m0 + RB >= M) next.load(X, w, y, c0 + STAGE, min(STAGE, b1 - c0 - STAGE));
        const int nr = min(RB, (M - m0 + 15) & ~15);
        for (int r0 = 0; r0 < nr; r0 += 16) {
          float f[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int r = r0 + 2 * q + h;
            f[q] = tq[r] * (v * phi(fam, u_at<DC>(zq, RB, r, xs, j, sS, Dk)));
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) p += f[q];
        }
      }
      part[h * STAGE + j] = p;
      __syncthreads();
      if (tid < STAGE) {
        const float e = ys[tid] - (part[tid] + part[STAGE + tid]);
        sqp += ws[tid] * e * e;
      }
    }
    sqp = block_sum(sqp, red);
    if (tid == 0) part[0] = sqp;
    const bool last = gather(part, 1, slots, tickets + unit, rank, C, flag);
    if (last && tid == 0) *sq = part[0];
    return;
  }

  int I = 0;  // unit 1 + I (I + 1) / 2 + J is the block (I, J)
  while ((I + 1) * (I + 2) / 2 <= unit - 1) ++I;
  const int J = unit - 1 - I * (I + 1) / 2;
  const int i0 = I * FWD_BLOCK, k0 = J * FWD_BLOCK;
  const bool diag = I == J;
  stage_rows<DC>(zI, Z, i0, FWD_BLOCK, M, Dk);
  stage_rows<DC>(zJ, Z, k0, FWD_BLOCK, M, Dk);

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
  const float4* kI4 = reinterpret_cast<const float4*>(kI);
  const float4* kw4 = reinterpret_cast<const float4*>(kw);
  const int ra = 2 * (lane >> 3), ca = lane & 7;  // the lane's rows 4 ra .. + 8, columns 4 ca .. + 4
  const bool rowI = i0 + lane < M, rowJ = k0 + lane < M;
  constexpr int NJ = STAGE / WARPS;  // the columns a thread builds in a pass
  for (int c0 = b0; c0 < b1; c0 += STAGE) {
    const int nc = min(STAGE, b1 - c0);
    // the previous pass's build is done with xs and ws (its barrier passed)
    put_columns<DC>(next, xs, ws, nullptr, X, w, y, c0, nc, Dk);
    __syncthreads();  // xs, ws in; the previous pass's products are done with kI, kw
    // kI[j][r] = K[i0 + r, c0 + j], kw[j][r] = w K[k0 + r, c0 + j] for the
    // thread's row r = lane and columns j = warp + 8 it: column-major in b
    float kiv[NJ], kjv[NJ];
#pragma unroll
    for (int it = 0; it < NJ; ++it) {
      const int j = warp + WARPS * it;
      const float ki = v * phi(fam, u_at<DC>(zI, FWD_BLOCK, lane, xs, j, sS, Dk));
      kiv[it] = j < nc && rowI ? ki : 0.0f;
      if (diag) {
        kjv[it] = kiv[it] * ws[j];
      } else {
        const float kj = v * phi(fam, u_at<DC>(zJ, FWD_BLOCK, lane, xs, j, sS, Dk));
        kjv[it] = (j < nc && rowJ ? kj : 0.0f) * ws[j];
      }
    }
#pragma unroll
    for (int it = 0; it < NJ; ++it) {
      kI[(warp + WARPS * it) * FWD_BLOCK + lane] = kiv[it];
      kw[(warp + WARPS * it) * FWD_BLOCK + lane] = kjv[it];
    }
    __syncthreads();
    if (DC == 1) next.load(X, w, y, c0 + STAGE, min(STAGE, b1 - c0 - STAGE));
#pragma unroll 4
    for (int j = warp; j < nc; j += WARPS) {
      const float4 a0 = kI4[j * 8 + ra], a1 = kI4[j * 8 + ra + 1];
      const float4 c = kw4[j * 8 + ca];
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] += av[r] * cv[q];
    }
  }
  __syncthreads();  // kI and kw become the warps' tiles
  float4* tiles4 = reinterpret_cast<float4*>(kI);
#pragma unroll
  for (int r = 0; r < 8; ++r)
    tiles4[warp * 256 + (4 * ra + r) * 8 + ca] =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int e = tid; e < FWD_BLOCK * FWD_BLOCK; e += THREADS) {
    float a = 0.0f;
    for (int q = 0; q < WARPS; ++q) a += kI[q * FWD_BLOCK * FWD_BLOCK + e];
    part[e] = a;
  }
  const bool last = gather(part, FWD_BLOCK * FWD_BLOCK, slots, tickets + unit, rank, C, flag);
  if (!last) return;
  for (int e = tid; e < FWD_BLOCK * FWD_BLOCK; e += THREADS) {
    const int rl = e >> 5, cl = e & 31, gi = i0 + rl, gk = k0 + cl;
    if (gi < M && gk < M && (!diag || rl >= cl)) {
      G[(size_t)gi * M + gk] = part[e];
      G[(size_t)gk * M + gi] = part[e];
    }
  }
}

// -- the backward -----------------------------------------------------------

// Shared memory in floats: Kc (KC x STAGE), hT (KC x 16), zc (D x KC), tc
// (KC), xs (D x STAGE), zP (D x 16), tP (16), w2s (16 x STAGE), ws, ys, wes
// (STAGE), mred (2 x STAGE), zacc (16 x D), sacc (WARPS x D), tred
// (WARPS x 16), part (16 + 16 D + D + 1), sS (D), red (32), flag (1).
__host__ __device__ inline int bwd_smem_floats(int D, int KC) {
  return KC * STAGE + KC * BWD_ROWS + D * KC + KC + D * STAGE + D * BWD_ROWS + BWD_ROWS +
         BWD_ROWS * STAGE + 3 * STAGE + 2 * STAGE + BWD_ROWS * D + WARPS * D +
         WARPS * BWD_ROWS + (BWD_ROWS + BWD_ROWS * D + D + 1) + D + 32 + 1;
}

template <int DC>
__global__ void __launch_bounds__(THREADS, 2) gram_bwd_kernel(
    const float* __restrict__ Z, const float* __restrict__ X, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ t, const float* __restrict__ vp,
    const float* __restrict__ s, int ns, const float* __restrict__ Gbar,
    const float* __restrict__ sqbarp, float* __restrict__ zbar, float* __restrict__ ybar,
    float* __restrict__ tbar, float* __restrict__ vbar, float* __restrict__ sbar,
    float* __restrict__ scratch, unsigned* __restrict__ tickets, int M, int B, int D, int chunk,
    int kc_rows, int fam) {
  extern __shared__ float4 smem4[];
  const int Dk = DC ? DC : D;
  const int KC = DC == 1 ? 128 : kc_rows;  // rows of Kuf a pass builds
  float* Kc = reinterpret_cast<float*>(smem4);
  float* hT = Kc + KC * STAGE;
  float* zc = hT + KC * BWD_ROWS;
  float* tc = zc + Dk * KC;
  float* xs = tc + KC;
  float* zP = xs + Dk * STAGE;
  float* tP = zP + Dk * BWD_ROWS;
  float* w2s = tP + BWD_ROWS;
  float* ws = w2s + BWD_ROWS * STAGE;
  float* ys = ws + STAGE;
  float* wes = ys + STAGE;
  float* mred = wes + STAGE;
  float* zacc = mred + 2 * STAGE;
  float* sacc = zacc + BWD_ROWS * Dk;
  float* tred = sacc + WARPS * Dk;
  float* part = tred + WARPS * BWD_ROWS;
  float* sS = part + BWD_ROWS + BWD_ROWS * Dk + Dk + 1;
  float* red = sS + Dk;
  int* flag = reinterpret_cast<int*>(red + 32);

  const int C = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit = blockIdx.y, U = gridDim.y, p0 = unit * BWD_ROWS;
  const int b0 = rank * chunk, b1 = min(B, b0 + chunk);
  const float v = vp[0], sqbar = sqbarp[0];
  for (int d = tid; d < Dk; d += THREADS) sS[d] = s[ns == 1 ? 0 : d];
  stage_rows<DC>(zP, Z, p0, BWD_ROWS, M, Dk);
  if (tid < BWD_ROWS) tP[tid] = p0 + tid < M ? t[p0 + tid] : 0.0f;
  for (int i = tid; i < BWD_ROWS * Dk; i += THREADS) zacc[i] = 0.0f;
  for (int i = tid; i < WARPS * Dk; i += THREADS) sacc[i] = 0.0f;
  Columns next;
  if (DC == 1) next.load(X, w, y, b0, min(STAGE, b1 - b0));

  // The product's warp (wc, wk) takes columns 64 wc .. 64 wc + 63 and rows
  // k = wk, wk + 4, .. of Kuf; a lane 8 rows (8 rg ..) x 4 columns (64 wc +
  // 4 cg ..). The build and the epilogue give a thread column jb and rows
  // of parity `half`.
  const int wc = warp & 1, wk = warp >> 1, rg = lane >> 4, cg4 = lane & 15;
  const int jb = tid & (STAGE - 1), half = tid >> 7;
  const int nkc = (M + KC - 1) / KC;
  // Rows q0 .. q0 + KC - 1 of Kuf: Z, t, and H's rows p0 .. p0 + 15 at those
  // columns (hT[k][r]). G-bar[p, q] is read along q into a padded transpose
  // in Kc (free until the build), then G-bar[q, p] along p is added: both
  // reads coalesced, four entries' loads in flight a thread. Every thread
  // takes part (one barrier inside).
  auto stage_chunk = [&](int q0, int nk) {
    stage_rows<DC>(zc, Z, q0, KC, M, Dk);
    for (int k = tid; k < KC; k += THREADS) tc[k] = k < nk ? t[q0 + k] : 0.0f;
    float* gT = Kc;  // gT[r * (KC + 1) + k] = G-bar[p0 + r, q0 + k]
    for (int i0 = 0; i0 < KC * BWD_ROWS; i0 += 4 * THREADS) {
      float hv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + q * THREADS + tid, r = i / KC, k = i - r * KC;
        hv[q] = k < nk && p0 + r < M ? Gbar[(size_t)(p0 + r) * M + q0 + k] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + q * THREADS + tid, r = i / KC, k = i - r * KC;
        gT[r * (KC + 1) + k] = hv[q];
      }
    }
    __syncthreads();
    for (int i0 = 0; i0 < KC * BWD_ROWS; i0 += 4 * THREADS) {
      float hv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + q * THREADS + tid, k = i >> 4, p = p0 + (i & 15);
        hv[q] = k < nk && p < M ? Gbar[(size_t)(q0 + k) * M + p] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + q * THREADS + tid;
        hT[i] = gT[(i & 15) * (KC + 1) + (i >> 4)] + hv[q];
      }
    }
  };
  if (nkc == 1) stage_chunk(0, M);  // one chunk: staged once, with the first columns
  float tp[BWD_ROWS / 2], vpart = 0.0f;
#pragma unroll
  for (int i = 0; i < BWD_ROWS / 2; ++i) tp[i] = 0.0f;
  for (int c0 = b0; c0 < b1; c0 += STAGE) {
    const int nc = min(STAGE, b1 - c0);
    __syncthreads();  // the previous pass is done with xs, ws, ys, wes and w2s
    put_columns<DC>(next, xs, ws, ys, X, w, y, c0, nc, Dk);
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    float mp = 0.0f;
    for (int kc = 0; kc < nkc; ++kc) {
      const int q0 = kc * KC, nk = min(KC, M - q0);
      if (nkc > 1) {
        if (kc > 0) __syncthreads();  // the previous chunk's product is done with hT, zc, tc
        stage_chunk(q0, nk);
      }
      __syncthreads();
      // Kc[k][j] = K[q0 + k, c0 + j] for the thread's column jb and rows
      // k = half + 2 i, eight in flight; m on the side
      for (int i0 = 0; i0 < KC / 2; i0 += 8) {
        float kv[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int k = half + 2 * (i0 + q);
          const float kk = v * phi(fam, u_at<DC>(zc, KC, k, xs, jb, sS, Dk));
          kv[q] = k < nk && jb < nc ? kk : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int k = half + 2 * (i0 + q);
          Kc[k * STAGE + jb] = kv[q];
          mp += tc[k] * kv[q];
        }
      }
      __syncthreads();
      if (DC == 1 && kc == nkc - 1) next.load(X, w, y, c0 + STAGE, min(STAGE, b1 - c0 - STAGE));
      const float4* h4 = reinterpret_cast<const float4*>(hT);
      const float4* k4 = reinterpret_cast<const float4*>(Kc);
#pragma unroll 2
      for (int k = wk; k < nk; k += 4) {
        const float4 ha = h4[k * 4 + 2 * rg], hb = h4[k * 4 + 2 * rg + 1];
        const float4 kk = k4[k * 32 + 16 * wc + cg4];
        const float hv[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] += hv[r] * kv[q];
      }
    }
    __syncthreads();  // every product is done with Kc: it holds the four partial H Kuf
    float4* hk4 = reinterpret_cast<float4*>(Kc);  // hk[wk][r][j]
#pragma unroll
    for (int r = 0; r < 8; ++r)
      hk4[(wk * BWD_ROWS + 8 * rg + r) * (STAGE / 4) + 16 * wc + cg4] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    mred[half * STAGE + jb] = mp;
    __syncthreads();
    if (tid < STAGE) {
      const float e = ys[tid] - (mred[tid] + mred[STAGE + tid]);
      const float we = ws[tid] * e;
      wes[tid] = we;
      if (unit == 0 && tid < nc) ybar[c0 + tid] = 2.0f * sqbar * we;
    }
    __syncthreads();
    // Kbar, phi and phi' at the thread's column jb and rows r = half + 2 i
    // (loads first, then the arithmetic); W2 to shared memory
    const float wj = ws[jb], wej = wes[jb];
    float w2[BWD_ROWS / 2];
#pragma unroll
    for (int i = 0; i < BWD_ROWS / 2; ++i) {
      const int r = half + 2 * i;
      float hk = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) hk += Kc[(q * BWD_ROWS + r) * STAGE + jb];
      const float kbar = wj * hk - 2.0f * sqbar * tP[r] * wej;
      float f, fp;
      phi_both(fam, u_at<DC>(zP, BWD_ROWS, r, xs, jb, sS, Dk), f, fp);
      tp[i] += wej * (v * f);
      vpart += kbar * f;
      w2[i] = kbar * (v * fp);
    }
#pragma unroll
    for (int i = 0; i < BWD_ROWS / 2; ++i) w2s[(half + 2 * i) * STAGE + jb] = w2[i];
    __syncthreads();
    // Z-bar and s-bar: warp w takes rows w and w + 8, lanes over the columns
    for (int r = warp; r < BWD_ROWS; r += WARPS) {
      if (p0 + r >= M) continue;
      for (int d = 0; d < Dk; ++d) {
        const float z = zP[d * BWD_ROWS + r];
        float zs = 0.0f, ss = 0.0f;
        for (int j = lane; j < nc; j += 32) {
          const float diff = z - xs[d * STAGE + j];
          const float a = w2s[r * STAGE + j] * diff;
          zs += a;
          ss += a * diff;
        }
        zs = warp_sum(zs);
        ss = warp_sum(ss);
        if (lane == 0) {
          zacc[r * Dk + d] += zs;
          sacc[warp * Dk + d] += ss;
        }
      }
    }
  }

  // The CTA's partials: t-bar over a warp's columns, then over the four
  // warps of the row parity
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BWD_ROWS / 2; ++i) {
    const float a = warp_sum(tp[i]);
    if (lane == 0) tred[warp * (BWD_ROWS / 2) + i] = a;
  }
  vpart = block_sum(vpart, red);
  const int NP = BWD_ROWS + BWD_ROWS * Dk + Dk + 1;
  if (tid < BWD_ROWS) {  // row tid: parity tid & 1, warps 4 (tid & 1) ..
    float a = 0.0f;
    for (int q = 0; q < WARPS / 2; ++q)
      a += tred[((tid & 1) * (WARPS / 2) + q) * (BWD_ROWS / 2) + (tid >> 1)];
    part[tid] = a;
  }
  for (int i = tid; i < BWD_ROWS * Dk; i += THREADS) part[BWD_ROWS + i] = zacc[i];
  for (int d = tid; d < Dk; d += THREADS) {
    float a = 0.0f;
    for (int q = 0; q < WARPS; ++q) a += sacc[q * Dk + d];
    part[BWD_ROWS + BWD_ROWS * Dk + d] = a;
  }
  if (tid == 0) part[NP - 1] = vpart;
  __syncthreads();
  // The unit's sums over its C CTAs: rows p0 .. p0 + 15 of t-bar and Z-bar
  const bool last = gather(part, NP, scratch + (size_t)U * (Dk + 1) + (size_t)unit * C * NP,
                           tickets + unit, rank, C, flag);
  if (!last) return;
  for (int i = tid; i < BWD_ROWS + BWD_ROWS * Dk; i += THREADS) {
    if (i < BWD_ROWS) {
      if (p0 + i < M) tbar[p0 + i] = -2.0f * sqbar * part[i];
    } else {
      const int r = (i - BWD_ROWS) / Dk, d = (i - BWD_ROWS) - r * Dk;
      if (p0 + r < M) zbar[(size_t)(p0 + r) * Dk + d] = 2.0f * sS[d] * part[i];
    }
  }
  // s-bar and v-bar span the units: the last unit to finish sums the U
  // units' in unit order
  float* sv = part + BWD_ROWS + BWD_ROWS * Dk;
  const bool last_unit = gather(sv, Dk + 1, scratch, tickets + U, unit, U, flag);
  if (!last_unit) return;
  for (int i = tid; i <= Dk; i += THREADS) {
    if (i < Dk) sbar[i] = sv[i];
    else *vbar = sv[i];
  }
}

// -- host side ---------------------------------------------------------------

static int smem_optin() {
  static int bytes = -1;
  if (bytes < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes;
}

template <typename Kernel>
static cudaError_t configure(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
}

// Each kernel's attributes, set once: the forward (bwd = false) or the
// backward, for D = 1 (DC = 1) or any D.
template <bool BWD, int DC>
static cudaError_t configured() {
  static cudaError_t state = cudaErrorNotReady;
  if (state != cudaSuccess)
    state = BWD ? configure(gram_bwd_kernel<DC>) : configure(gram_fwd_kernel<DC>);
  return state;
}

static int fwd_units(int M) {
  const int T = (M + FWD_BLOCK - 1) / FWD_BLOCK;
  return T * (T + 1) / 2 + 1;
}

static int bwd_units(int M) { return (M + BWD_ROWS - 1) / BWD_ROWS; }

// The geometry the wrapper computed (python: svgp_gram.launch_shape): C
// ranks of `chunk` columns cover B, and the shared memory is this source's.
static bool geometry_ok(int M, int B, int D, int C, int chunk, int units, size_t smem,
                        size_t want) {
  return M > 0 && M % 8 == 0 && D >= 1 && D <= MAX_D && B >= 0 && C >= 1 && C <= MAX_RANKS &&
         chunk >= 0 && (long long)chunk * C >= B && units <= 65535 && smem == want &&
         smem <= (size_t)smem_optin();
}

static cudaLaunchConfig_t launch_config(int C, int units, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, units, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  return cfg;
}

template <int DC>
static cudaError_t launch_fwd(const cudaLaunchConfig_t& cfg, const float* Z, const float* X,
                              const float* y, const float* w, const float* t, const float* v,
                              const float* s, int ns, float* G, float* sq, float* scratch,
                              unsigned* tickets, int M, int B, int D, int chunk, int fam) {
  const cudaError_t e = configured<false, DC>();
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, gram_fwd_kernel<DC>, Z, X, y, w, t, v, s, ns, G, sq, scratch,
                            tickets, M, B, D, chunk, fam);
}

template <int DC>
static cudaError_t launch_bwd(const cudaLaunchConfig_t& cfg, const float* Z, const float* X,
                              const float* y, const float* w, const float* t, const float* v,
                              const float* s, int ns, const float* Gbar, const float* sqbar,
                              float* zbar, float* ybar, float* tbar, float* vbar, float* sbar,
                              float* scratch, unsigned* tickets, int M, int B, int D, int chunk,
                              int KC, int fam) {
  const cudaError_t e = configured<true, DC>();
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, gram_bwd_kernel<DC>, Z, X, y, w, t, v, s, ns, Gbar, sqbar,
                            zbar, ybar, tbar, vbar, sbar, scratch, tickets, M, B, D, chunk, KC,
                            fam);
}

// scratch: the C partials of each of the U units, U C 1024 floats when C > 1
// (unused when C = 1); tickets: U zeros, left zero.
extern "C" int svgp_gram_fwd_launch(const float* Z, const float* X, const float* y,
                                    const float* w, const float* t, const float* v,
                                    const float* s, int ns, float* G, float* sq, float* scratch,
                                    unsigned* tickets, int M, int B, int D, int fam, int C,
                                    int chunk, int smem, void* stream) {
  const int units = fwd_units(M);
  if (!geometry_ok(M, B, D, C, chunk, units, (size_t)smem,
                   (size_t)fwd_smem_floats(D) * sizeof(float)) ||
      (ns != 1 && ns != D))
    return (int)cudaErrorInvalidValue;
  const cudaLaunchConfig_t cfg =
      launch_config(C, units, smem, static_cast<cudaStream_t>(stream));
  const cudaError_t e =
      D == 1 ? launch_fwd<1>(cfg, Z, X, y, w, t, v, s, ns, G, sq, scratch, tickets, M, B, D,
                             chunk, fam)
             : launch_fwd<0>(cfg, Z, X, y, w, t, v, s, ns, G, sq, scratch, tickets, M, B, D,
                             chunk, fam);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// scratch: U (D + 1) floats for the units' s-bar and v-bar, then, when
// C > 1, the C partials of each unit (U C (16 + 16 D + D + 1) floats), U =
// ceil(M / 16); tickets: U + 1 zeros, left zero.
extern "C" int svgp_gram_bwd_launch(const float* Z, const float* X, const float* y,
                                    const float* w, const float* t, const float* v,
                                    const float* s, int ns, const float* Gbar,
                                    const float* sqbar, float* zbar, float* ybar, float* tbar,
                                    float* vbar, float* sbar, float* scratch, unsigned* tickets,
                                    int M, int B, int D, int fam, int C, int chunk, int KC,
                                    int smem, void* stream) {
  const int units = bwd_units(M);
  if (!geometry_ok(M, B, D, C, chunk, units, (size_t)smem,
                   (size_t)bwd_smem_floats(D, KC) * sizeof(float)) ||
      (ns != 1 && ns != D) || KC < 64 || KC % 16 || (D == 1 && KC != 128))
    return (int)cudaErrorInvalidValue;
  const cudaLaunchConfig_t cfg =
      launch_config(C, units, smem, static_cast<cudaStream_t>(stream));
  const cudaError_t e =
      D == 1 ? launch_bwd<1>(cfg, Z, X, y, w, t, v, s, ns, Gbar, sqbar, zbar, ybar, tbar, vbar,
                             sbar, scratch, tickets, M, B, D, chunk, KC, fam)
             : launch_bwd<0>(cfg, Z, X, y, w, t, v, s, ns, Gbar, sqbar, zbar, ybar, tbar, vbar,
                             sbar, scratch, tickets, M, B, D, chunk, KC, fam);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <bool BWD, int DC>
static cudaError_t blocks_per_sm(int smem, int* out) {
  const cudaError_t e = configured<BWD, DC>();
  if (e != cudaSuccess) return e;
  return BWD ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, gram_bwd_kernel<DC>, THREADS,
                                                             smem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, gram_fwd_kernel<DC>, THREADS,
                                                             smem);
}

// How many CTAs with `smem` bytes each an SM holds at once, for the forward
// (bwd = 0) or the backward at D.
extern "C" int svgp_gram_blocks_per_sm(int bwd, int D, int smem, int* out) {
  cudaError_t e;
  if (bwd) e = D == 1 ? blocks_per_sm<true, 1>(smem, out) : blocks_per_sm<true, 0>(smem, out);
  else e = D == 1 ? blocks_per_sm<false, 1>(smem, out) : blocks_per_sm<false, 0>(smem, out);
  return (int)e;
}
