// The batch phase of the Gaussian SVGP ELBO for Hopper: one forward and one
// backward kernel, each a tile pass over the minibatch and a deterministic
// reduction of the tiles' partials.
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
// Design. A grid of CTAs over tiles of BT columns of X (BT = 64 up to
// M ~ 400, fewer beyond, chosen by the wrapper). Each CTA builds its M x BT
// tile of Kuf in shared memory (32 KB at M = 128), stored column-major in b so
// that a column of Kuf is contiguous. The forward takes the tile's m, e and
// sum w e^2, and its partial G over 4 x 4 register micro-tiles of the lower
// triangle (float4 shared-memory loads, 16 FMAs per 8 loads). The backward
// forms H once (a small kernel), multiplies H by the tile on 4 x 4 micro-tiles
// (H read through L1, Kuf from shared memory), then W2 in a second shared
// buffer, then per-tile partials of t-bar, v-bar, Z-bar and s-bar. A second
// kernel sums the partials over tiles in a fixed order, so reruns agree bit
// for bit (no atomics) and mirrors G's lower triangle.
//
// Bound on an H100 (SXM, 700 W) at the benchmark shape (M, B, D) =
// (128, 2048, 1): G is symmetric, so the forward needs only its lower
// triangle, M (M + 1) B = 34 MFLOP (~0.5 us at 67 TFLOP/s of fp32); the
// backward's H Kuf is a full 2 M^2 B = 67 MFLOP (~1 us). Both read and write
// ~0.1 MB: operations bound. With 32 CTAs on 132 SMs and
// CUDA-core FMAs this first version is far from that; tensor-core (wgmma)
// products and a persistent grid are later work. Everything is plain fp32
// (no TF32), the counterpart of the TPU kernel's Precision.HIGHEST.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define THREADS 256

enum Family { FAM_SE = 0, FAM_MATERN12 = 1, FAM_MATERN32 = 2, FAM_MATERN52 = 3 };

// phi and d phi / du; mirror stationary_nll._phi and _phi_prime (the matern12
// derivative is masked to 0 at u <= 1e-12, where it is singular).
__device__ __forceinline__ float phi(int fam, float u) {
  const float SQRT3 = 1.7320508075688772f;
  const float SQRT5 = 2.23606797749979f;
  if (fam == FAM_SE) return expf(-0.5f * u);
  const float r = sqrtf(fmaxf(u, 0.0f));
  if (fam == FAM_MATERN12) return expf(-r);
  if (fam == FAM_MATERN32) return (1.0f + SQRT3 * r) * expf(-SQRT3 * r);
  return (1.0f + SQRT5 * r + (5.0f / 3.0f) * u) * expf(-SQRT5 * r);
}

__device__ __forceinline__ float phi_prime(int fam, float u) {
  const float SQRT3 = 1.7320508075688772f;
  const float SQRT5 = 2.23606797749979f;
  if (fam == FAM_SE) return -0.5f * expf(-0.5f * u);
  const float r = sqrtf(fmaxf(u, 1e-20f));
  if (fam == FAM_MATERN12) return u > 1e-12f ? -expf(-r) / (2.0f * r) : 0.0f;
  if (fam == FAM_MATERN32) return -1.5f * expf(-SQRT3 * r);
  return -(5.0f / 6.0f) * (1.0f + SQRT5 * r) * expf(-SQRT5 * r);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum of x over the block; every thread gets it. `red` holds 32 floats.
__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < (blockDim.x >> 5) ? red[lane] : 0.0f;
  return warp_sum(x);
}

__device__ __forceinline__ float u_of(const float* __restrict__ Z, const float* __restrict__ X,
                                      const float* __restrict__ s, int m, int b, int D) {
  float u = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float diff = Z[(size_t)m * D + d] - X[(size_t)b * D + d];
    u += s[d] * (diff * diff);
  }
  return u;
}

// Kt[j*M + m] = v phi(u[m, b0 + j]); 0 for columns past B.
__device__ void build_tile(float* Kt, const float* __restrict__ Z, const float* __restrict__ X,
                           const float* __restrict__ s, float v, int fam, int b0, int M, int B,
                           int D, int BT) {
  for (int idx = threadIdx.x; idx < BT * M; idx += blockDim.x) {
    const int j = idx / M, m = idx - j * M, b = b0 + j;
    Kt[idx] = b < B ? v * phi(fam, u_of(Z, X, s, m, b, D)) : 0.0f;
  }
}

// e[j] = y_b - sum_m t_m Kt[j, m] for the tile's columns b = b0 + j, one warp
// per column; 0 past B.
__device__ void residuals(const float* Kt, const float* tS, float* e,
                          const float* __restrict__ y, int b0, int M, int B, int BT) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int j = warp; j < BT; j += nw) {
    float p = 0.0f;
    for (int m = lane; m < M; m += 32) p += tS[m] * Kt[(size_t)j * M + m];
    p = warp_sum(p);
    if (lane == 0) e[j] = b0 + j < B ? y[b0 + j] - p : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS) gram_fwd_tile(
    const float* __restrict__ Z, const float* __restrict__ X, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ t, const float* __restrict__ vp,
    const float* __restrict__ s, float* __restrict__ gpart, float* __restrict__ sqpart,
    int M, int B, int D, int BT, int fam) {
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // BT x M
  float* tS = Kt + (size_t)BT * M;             // M
  float* wS = tS + M;                          // BT
  float* e = wS + BT;                          // BT
  float* red = e + BT;                         // 32
  const int tile = blockIdx.x, b0 = tile * BT, tid = threadIdx.x;
  for (int m = tid; m < M; m += blockDim.x) tS[m] = t[m];
  for (int j = tid; j < BT; j += blockDim.x) wS[j] = b0 + j < B ? w[b0 + j] : 0.0f;
  build_tile(Kt, Z, X, s, vp[0], fam, b0, M, B, D, BT);
  __syncthreads();

  residuals(Kt, tS, e, y, b0, M, B, BT);
  __syncthreads();
  float part = 0.0f;
  for (int j = tid; j < BT; j += blockDim.x) part += wS[j] * e[j] * e[j];
  part = block_sum(part, red);
  if (tid == 0) sqpart[tile] = part;

  // Partial G on the lower-triangular 4 x 4 micro-tiles (bi >= bk).
  const int MT = M / 4;
  const int ntiles = MT * (MT + 1) / 2;
  float* g = gpart + (size_t)tile * M * M;
  for (int p = tid; p < ntiles; p += blockDim.x) {
    int bi = (int)((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
    while (bi * (bi + 1) / 2 > p) --bi;
    while ((bi + 1) * (bi + 2) / 2 <= p) ++bi;
    const int bk = p - bi * (bi + 1) / 2;
    float acc[4][4] = {};
    for (int j = 0; j < BT; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(Kt + (size_t)j * M + 4 * bi);
      float4 c = *reinterpret_cast<const float4*>(Kt + (size_t)j * M + 4 * bk);
      const float wj = wS[j];
      c.x *= wj; c.y *= wj; c.z *= wj; c.w *= wj;
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] += av[r] * cv[q];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) g[(size_t)(4 * bi + r) * M + 4 * bk + q] = acc[r][q];
  }
}

// G[i, k] = sum over tiles of the lower entry (max(i,k), min(i,k)); sq likewise.
__global__ void gram_fwd_reduce(const float* __restrict__ gpart,
                                const float* __restrict__ sqpart, float* __restrict__ G,
                                float* __restrict__ sq, int M, int T) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < M * M) {
    const int i = idx / M, k = idx - i * M;
    const size_t src = i >= k ? (size_t)i * M + k : (size_t)k * M + i;
    float acc = 0.0f;
    for (int tt = 0; tt < T; ++tt) acc += gpart[(size_t)tt * M * M + src];
    G[idx] = acc;
  }
  if (idx == 0) {
    float acc = 0.0f;
    for (int tt = 0; tt < T; ++tt) acc += sqpart[tt];
    *sq = acc;
  }
}

// H = G-bar + G-bar^T.
__global__ void symmetrize(const float* __restrict__ Gbar, float* __restrict__ H, int M) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < M * M) {
    const int i = idx / M, k = idx - i * M;
    H[idx] = Gbar[idx] + Gbar[(size_t)k * M + i];
  }
}

__global__ void __launch_bounds__(THREADS) gram_bwd_tile(
    const float* __restrict__ Z, const float* __restrict__ X, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ t, const float* __restrict__ vp,
    const float* __restrict__ s, const float* __restrict__ H, const float* __restrict__ sqbarp,
    float* __restrict__ ybar, float* __restrict__ zpart, float* __restrict__ tpart,
    float* __restrict__ spart, float* __restrict__ vpart, int M, int B, int D, int BT, int fam) {
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // BT x M: Kuf
  float* Kb = Kt + (size_t)BT * M;             // BT x M: Kbar, then W2
  float* tS = Kb + (size_t)BT * M;             // M
  float* wS = tS + M;                          // BT
  float* we = wS + BT;                         // BT
  float* xS = we + BT;                         // BT: one dimension of the tile's X
  float* red = xS + BT;                        // 32
  const int tile = blockIdx.x, b0 = tile * BT, tid = threadIdx.x;
  const float v = vp[0], sqbar = sqbarp[0];
  for (int m = tid; m < M; m += blockDim.x) tS[m] = t[m];
  for (int j = tid; j < BT; j += blockDim.x) wS[j] = b0 + j < B ? w[b0 + j] : 0.0f;
  build_tile(Kt, Z, X, s, v, fam, b0, M, B, D, BT);
  __syncthreads();

  residuals(Kt, tS, we, y, b0, M, B, BT);
  __syncthreads();
  for (int j = tid; j < BT; j += blockDim.x) {
    we[j] *= wS[j];
    if (b0 + j < B) ybar[b0 + j] = 2.0f * sqbar * we[j];
  }
  __syncthreads();
  // t-bar partial (the -2 sqbar factor is applied after the reduction)
  for (int m = tid; m < M; m += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < BT; ++j) acc += we[j] * Kt[(size_t)j * M + m];
    tpart[(size_t)tile * M + m] = acc;
  }

  // Kbar = (H Kuf) o w - 2 sqbar t (we)^T on 4 x 4 micro-tiles, m fastest.
  const int MT = M / 4, JT = BT / 4;
  for (int p = tid; p < MT * JT; p += blockDim.x) {
    const int mi = p % MT, ji = p / MT;
    float acc[4][4] = {};  // [m][j]
    for (int k = 0; k < M; ++k) {
      // H is symmetric: row k read as column k, contiguous in m
      const float4 h = __ldg(reinterpret_cast<const float4*>(H + (size_t)k * M + 4 * mi));
      const float hv[4] = {h.x, h.y, h.z, h.w};
      float kv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) kv[q] = Kt[(size_t)(4 * ji + q) * M + k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] += hv[r] * kv[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * ji + q;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = 4 * mi + r;
        Kb[(size_t)j * M + m] = acc[r][q] * wS[j] - 2.0f * sqbar * tS[m] * we[j];
      }
    }
  }
  __syncthreads();

  // v-bar partial and W2 = Kbar v phi'(u), in place.
  float vloc = 0.0f;
  for (int idx = tid; idx < BT * M; idx += blockDim.x) {
    const int j = idx / M, m = idx - j * M, b = b0 + j;
    float w2 = 0.0f;
    if (b < B) {
      const float u = u_of(Z, X, s, m, b, D);
      vloc += Kb[idx] * phi(fam, u);
      w2 = Kb[idx] * (v * phi_prime(fam, u));
    }
    Kb[idx] = w2;
  }
  vloc = block_sum(vloc, red);
  if (tid == 0) vpart[tile] = vloc;

  // Z-bar and s-bar partials, one dimension at a time, by differences.
  for (int d = 0; d < D; ++d) {
    __syncthreads();
    for (int j = tid; j < BT; j += blockDim.x)
      xS[j] = b0 + j < B ? X[(size_t)(b0 + j) * D + d] : 0.0f;
    __syncthreads();
    float sloc = 0.0f;
    for (int m = tid; m < M; m += blockDim.x) {
      const float z = Z[(size_t)m * D + d];
      float zacc = 0.0f, sacc = 0.0f;
      for (int j = 0; j < BT; ++j) {
        const float diff = z - xS[j];
        const float a = Kb[(size_t)j * M + m] * diff;
        zacc += a;
        sacc += a * diff;
      }
      zpart[((size_t)tile * M + m) * D + d] = zacc;
      sloc += sacc;
    }
    sloc = block_sum(sloc, red);
    if (tid == 0) spart[(size_t)tile * D + d] = sloc;
  }
}

// Sums the tiles' partials in a fixed order: Z-bar (M*D), t-bar (M), s-bar (D), v-bar.
__global__ void gram_bwd_reduce(const float* __restrict__ zpart, const float* __restrict__ tpart,
                                const float* __restrict__ spart, const float* __restrict__ vpart,
                                const float* __restrict__ s, const float* __restrict__ sqbarp,
                                float* __restrict__ zbar, float* __restrict__ tbar,
                                float* __restrict__ sbar, float* __restrict__ vbar, int M, int D,
                                int T) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  if (idx < M * D) {
    for (int tt = 0; tt < T; ++tt) acc += zpart[(size_t)tt * M * D + idx];
    zbar[idx] = 2.0f * s[idx % D] * acc;
  } else if (idx < M * D + M) {
    const int m = idx - M * D;
    for (int tt = 0; tt < T; ++tt) acc += tpart[(size_t)tt * M + m];
    tbar[m] = -2.0f * sqbarp[0] * acc;
  } else if (idx < M * D + M + D) {
    const int d = idx - M * D - M;
    for (int tt = 0; tt < T; ++tt) acc += spart[(size_t)tt * D + d];
    sbar[d] = acc;
  } else if (idx == M * D + M + D) {
    for (int tt = 0; tt < T; ++tt) acc += vpart[tt];
    *vbar = acc;
  }
}

static int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static int num_tiles(int B, int BT) { return B > 0 ? (B + BT - 1) / BT : 1; }

extern "C" int svgp_gram_fwd_launch(const float* Z, const float* X, const float* y,
                                    const float* w, const float* t, const float* v,
                                    const float* s, float* G, float* sq, float* gpart,
                                    float* sqpart, int M, int B, int D, int BT, int fam,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = num_tiles(B, BT);
  const size_t smem = ((size_t)BT * M + M + 2 * BT + 32) * sizeof(float);
  int rc = set_smem((const void*)gram_fwd_tile, smem);
  if (rc) return rc;
  gram_fwd_tile<<<T, THREADS, smem, st>>>(Z, X, y, w, t, v, s, gpart, sqpart, M, B, D, BT, fam);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  gram_fwd_reduce<<<(M * M + 255) / 256, 256, 0, st>>>(gpart, sqpart, G, sq, M, T);
  return (int)cudaGetLastError();
}

extern "C" int svgp_gram_bwd_launch(const float* Z, const float* X, const float* y,
                                    const float* w, const float* t, const float* v,
                                    const float* s, const float* Gbar, const float* sqbar,
                                    float* zbar, float* ybar, float* tbar, float* vbar,
                                    float* sbar, float* H, float* zpart, float* tpart,
                                    float* spart, float* vpart, int M, int B, int D, int BT,
                                    int fam, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = num_tiles(B, BT);
  symmetrize<<<(M * M + 255) / 256, 256, 0, st>>>(Gbar, H, M);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const size_t smem = (2 * (size_t)BT * M + M + 3 * BT + 32) * sizeof(float);
  rc = set_smem((const void*)gram_bwd_tile, smem);
  if (rc) return rc;
  gram_bwd_tile<<<T, THREADS, smem, st>>>(Z, X, y, w, t, v, s, H, sqbar, ybar, zpart, tpart,
                                         spart, vpart, M, B, D, BT, fam);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int n = M * D + M + D + 1;
  gram_bwd_reduce<<<(n + 255) / 256, 256, 0, st>>>(zpart, tpart, spart, vpart, s, sqbar, zbar,
                                                   tbar, sbar, vbar, M, D, T);
  return (int)cudaGetLastError();
}
