// Fused masked stationary-GP negative log marginal likelihood for Hopper.
//
// Replaces the TPU kernels of portfoliooptgp_tpu/ops/pallas/stationary_nll.py:
//   _stg_kernel  (the masked sum/product of kernel atoms, the walk-forward loss)
//   _st_kernel / _st_inv_kernel  (one isotropic family, the fused_stationary tier)
// The second is the case J = 1, dims = (1,), mask = 1 of the first.
//
// For every model b (one CTA each):
//   K_b = (m⊗m) ∘ ⊕_j v_j φ_j(Σ_d s_{j,d} d2_{j,d}) + diag(m σ² + 1 − m),  ⊕ ∈ {Σ, Π}
//   L L^T = K_b,  a = L^{-1} err_b,  Σ log diag L,  optionally W = L^{-1}
//   nll_b = ½‖a‖² + Σ log diag L + ½ N log 2π   (2π at the full N; callers
//   restate it for the rows the mask keeps, as in the JAX package)
// A factor that goes indefinite gives sqrt of a negative pivot: NaN, never a
// clamp or jitter, so the line search rejects the step as on the TPU. From
// the first indefinite pivot k, a[k:] and the NLL are NaN and W[i][c] is NaN
// exactly for i >= k, c <= i, as in a column loop.
//
// Two kernels, chosen by N at the entry point:
//
// N <= 256: the tile kernel (stationary_nll_tile_kernel), csrc/dense_nll.cu's
// design on the tile core it shares with it (nll_tile.cuh): 256 threads, the
// lower triangle of K_b padded to Np = 32 T with an identity block as
// T (T + 1) / 2 tiles of 32 x 32 (36-float rows) in shared memory, factored
// in 32-column sub-panels by a warp factor, row solves (err rides along as
// one more row) and rank-32 updates, three barriers a sub-panel (24 at
// N = 256, where the column loop takes 768); with the flag, W formed after
// the factor a column per thread and written once, in coalesced rows. The
// one difference from the dense kernel is that K_b is built here, straight
// into the tiles, as the TPU kernel builds it on the chip, in place of
// dense_nll.cu's copy of a prebuilt K: each entry in the column loop's (and
// build_general_plain's) order of operations, masked rows as identity rows.
// The d2 matrices are shared by the batch and read through L2 by every CTA;
// a warp reads 32 consecutive floats of a d2 row, and a thread issues the
// loads of 8 entries (2 tiles) before it uses any, so that one L2 round
// trip serves 8 entries, and evaluates φ in one family's code, chosen once
// per atom (build_tiles). Rounding is the JAX kernel's
// (chol_tile.cuh: sqrt and division correctly rounded). Shared memory is
// dense_nll.cu's layout (205,952 B at N = 256 with W, 177,280 B without);
// the mask and the model's parameters sit in the factor's scratch until the
// build is done. Registers: 255 a thread (about 50 B of spills), one CTA an
// SM; B = 128 is one wave on 132 SMs.
//
// N > 256 (frontier grid A's 262, the router's window up to 512): the column
// loop (stationary_nll_kernel), one CTA of 1024 threads per model, K_b as a
// packed lower triangle in shared memory, a right-looking Cholesky with the
// forward solve, the log-det and the row operations that turn I into L^{-1}
// in the same column loop, three barriers a column, W rewritten in global
// memory at each column. Masked rows are identity rows; any N and B are
// taken. Where the packed factor does not fit shared memory (N above ~339)
// the wrapper passes a global-memory workspace and the same code runs on it.
//
// Bound on an H100 (SXM, 700 W): per model N^3/3 flops of factor plus N^3/3
// of inverse. At B = 128, N = 256 with W that is 1.4 GFLOP of fp32 (~21 us
// at 67 TFLOP/s) against 34 MB of W written (~10 us at 3.35 TB/s):
// operations bound. At the walk-forward shape (B = 5, N = 77) five CTAs
// occupy 5 of 132 SMs and the time is the latency of the chain: three warp
// factors of 32 dependent pivots, their row solves and the inverse's last
// row blocks (tools/kernel_timeline.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "chol_tile.cuh"
#include "nll_tile.cuh"

#define MAX_ATOMS 8
#define MAX_MATS 32
#define THREADS 1024  // 32 warps: the column loop's shared-memory latency needs them
#define TILE_THREADS 256  // the tile kernel: a warp per tile column (nll_tile.cuh)
#define MAX_TILE_N 256    // the tile kernel's N (T <= 8 tiles); the column loop above it
#define GROUP 2           // tiles a thread builds at once: 8 entries, their loads in flight together

enum Family {
  FAM_SE = 0,
  FAM_MATERN12 = 1,
  FAM_MATERN32 = 2,
  FAM_MATERN52 = 3,
  FAM_RQ = 4,
  FAM_PERIODIC_SE = 5,
  FAM_LINEAR = 6,
};

struct Atoms {
  int J;        // number of atoms
  int combine;  // 0: sum, 1: product
  int family[MAX_ATOMS];
  int dims[MAX_ATOMS];  // shared d2 matrices per atom (1 isotropic, D for ARD)
};

// Pointwise kernel shape K/v = φ(u) of family F; mirrors stationary_nll._phi.
template <int F>
__device__ __forceinline__ float phi_of(float u, float al) {
  const float SQRT3 = 1.7320508075688772f;
  const float SQRT5 = 2.23606797749979f;
  const float PI = 3.141592653589793f;
  if (F == FAM_SE) return expf(-0.5f * u);
  if (F == FAM_RQ) return expf(-al * log1pf(u / (2.0f * al)));
  if (F == FAM_LINEAR) return u;
  if (F == FAM_PERIODIC_SE) {
    const float sine = sinf(PI * sqrtf(fmaxf(u, 0.0f)));
    return expf(-0.5f * sine * sine / (al * al));
  }
  const float r = sqrtf(fmaxf(u, 0.0f));
  if (F == FAM_MATERN12) return expf(-r);
  if (F == FAM_MATERN32) return (1.0f + SQRT3 * r) * expf(-SQRT3 * r);
  return (1.0f + SQRT5 * r + (5.0f / 3.0f) * u) * expf(-SQRT5 * r);
}

// φ of a family chosen at run time (the column loop's form).
__device__ __forceinline__ float phi(int fam, float u, float al) {
  if (fam == FAM_SE) return phi_of<FAM_SE>(u, al);
  if (fam == FAM_RQ) return phi_of<FAM_RQ>(u, al);
  if (fam == FAM_LINEAR) return phi_of<FAM_LINEAR>(u, al);
  if (fam == FAM_PERIODIC_SE) return phi_of<FAM_PERIODIC_SE>(u, al);
  if (fam == FAM_MATERN12) return phi_of<FAM_MATERN12>(u, al);
  if (fam == FAM_MATERN32) return phi_of<FAM_MATERN32>(u, al);
  return phi_of<FAM_MATERN52>(u, al);
}

#define NE (4 * GROUP)  // entries a thread builds at once

// E[e] ⊕= v φ_F(U[e]) for the NE entries of a group: one family's code,
// unrolled, so that a group runs one straight run of instructions.
template <int F>
__device__ __forceinline__ void combine_atom(float (&E)[NE], const float (&U)[NE], float v,
                                             float al, int prod) {
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const float term = v * phi_of<F>(U[e], al);
    E[e] = prod ? E[e] * term : E[e] + term;
  }
}

// Build the T (T + 1) / 2 tiles of K_b (rows past N: an identity block) in
// shared memory. Warp w builds rows w, w + 8, w + 16 and w + 24 of each tile,
// lane l its column l, so a warp reads 32 consecutive floats of a d2 row;
// GROUP tiles at a time, the NE loads of each d2 matrix issued before any is
// used (entries outside the lower triangle load d2[0] and are not used).
// Not inlined, GROUP 2 and φ's family chosen once per atom: inlined, with
// GROUP 4 and the family chosen per entry, the build's unrolled copies of φ
// lengthened the kernel's code, the build took 57,000-67,000 cycles at
// B = 128, N = 256 (now 41,000-51,000) and the factor's first steps ran
// slower too (tools/kernel_timeline.py): 0.178 ms with W on an H100
// against 0.153 now.
// mk is the mask padded with zeros to Np; prm holds model b's s (MAX_MATS
// floats), v and α (MAX_ATOMS each), then the atoms' families and d2 counts
// (MAX_ATOMS ints each). Each entry is the column loop's, in its order of
// operations; zeros above the diagonal.
__device__ __noinline__ void build_tiles(float* tiles, const float* __restrict__ d2s,
                                            const float* mk, const float* prm, float nz, int N,
                                            int T, int J, int prod) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = T * (T + 1) / 2;
  const size_t NN = (size_t)N * N;
  const float* sv = prm;
  const float* vv = prm + MAX_MATS;
  const float* av = vv + MAX_ATOMS;
  const int* fams = reinterpret_cast<const int*>(av + MAX_ATOMS);
  const int* dims = fams + MAX_ATOMS;
  int R = 0, S = 0;  // the tile (R, S) that the next group starts with
  for (int t0 = 0; t0 < ntiles; t0 += GROUP) {
    int Rg[GROUP], Sg[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      Rg[g] = R, Sg[g] = S;
      if (++S > R) ++R, S = 0;
    }
    int idx[NE];
    float E[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int i = SP * Rg[e / 4] + warp + 8 * (e % 4), j = SP * Sg[e / 4] + lane;
      idx[e] = t0 + e / 4 < ntiles && i < N && j <= i ? i * N + j : 0;
      E[e] = prod ? 1.0f : 0.0f;
    }
    int off = 0;
    for (int q = 0; q < J; ++q) {
      float U[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) U[e] = 0.0f;
      for (int d = 0; d < dims[q]; ++d) {
        const float s = sv[off + d];
        const float* D = d2s + (size_t)(off + d) * NN;
        float v[NE];
#pragma unroll
        for (int e = 0; e < NE; ++e) v[e] = __ldg(D + idx[e]);
#pragma unroll
        for (int e = 0; e < NE; ++e) U[e] += s * v[e];
      }
      off += dims[q];
      const float vq = vv[q], al = av[q];
      switch (fams[q]) {
        case FAM_SE: combine_atom<FAM_SE>(E, U, vq, al, prod); break;
        case FAM_MATERN12: combine_atom<FAM_MATERN12>(E, U, vq, al, prod); break;
        case FAM_MATERN32: combine_atom<FAM_MATERN32>(E, U, vq, al, prod); break;
        case FAM_MATERN52: combine_atom<FAM_MATERN52>(E, U, vq, al, prod); break;
        case FAM_RQ: combine_atom<FAM_RQ>(E, U, vq, al, prod); break;
        case FAM_PERIODIC_SE: combine_atom<FAM_PERIODIC_SE>(E, U, vq, al, prod); break;
        default: combine_atom<FAM_LINEAR>(E, U, vq, al, prod); break;
      }
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if (t0 + e / 4 >= ntiles) continue;
      const int r = warp + 8 * (e % 4), i = SP * Rg[e / 4] + r, j = SP * Sg[e / 4] + lane;
      float k;
      if (i >= N) {
        k = i == j ? 1.0f : 0.0f;
      } else if (j > i) {
        k = 0.0f;
      } else {
        const float mi = mk[i], mj = mk[j];
        k = (mi * mj) * E[e];
        if (i == j) k += mi * nz + (1.0f - mi);
      }
      tiles[(t0 + e / 4) * TILE + r * LDT + lane] = k;
    }
  }
}

template <bool WITH_W>
__global__ void __launch_bounds__(TILE_THREADS, 1) stationary_nll_tile_kernel(
    const float* __restrict__ d2s,    // (JD, N, N)
    const float* __restrict__ err,    // (B, N)
    const float* __restrict__ mask,   // (B, N) or null for all ones
    const float* __restrict__ vs,     // (J, B)
    const float* __restrict__ ss,     // (JD, B), s = 1/ℓ²
    const float* __restrict__ als,    // (J, B)
    const float* __restrict__ noise,  // (B,)
    float* __restrict__ nll,          // (B,)
    float* __restrict__ a_out,        // (B, N)
    float* __restrict__ W,            // (B, N, N) when WITH_W
    int B, int N, Atoms atoms) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = (N + SP - 1) / SP, Np = SP * T;

  float* tiles = smem;                            // T (T + 1) / 2 tiles of K, L, then W
  float* LT = tiles + T * (T + 1) / 2 * TILE;     // the diagonal tiles of L transposed
  float* ay = LT + (WITH_W ? T : 1) * SP * SP;    // Np: err, then a = L^{-1} err
  float* dg = ay + Np;                            // Np: diag L
  float* yd = dg + Np;                            // Np: the estimates of 1 / diag L
  float* lt = yd + Np;                            // SP x SP: (a)'s scratch
  float* red = lt + SP * SP;                      // 32: block reduction
  float* mk = lt;                                 // Np: the mask, until K is built
  float* prm = lt + MAX_TILE_N;                   // model b's atoms, until K is built
  // Without W one transpose buffer serves every step (as in dense_nll.cu).
  auto Lt = [&](int k) { return LT + (WITH_W ? k : 0) * SP * SP; };

  // The atoms' fields by constant indices (an index known only at run time
  // would copy the struct to local memory), the model's parameters by thread.
  int JD = 0;
  int* fams = reinterpret_cast<int*>(prm + MAX_MATS + 2 * MAX_ATOMS);
#pragma unroll
  for (int q = 0; q < MAX_ATOMS; ++q) {
    JD += q < atoms.J ? atoms.dims[q] : 0;
    if (tid == q) fams[q] = atoms.family[q], fams[MAX_ATOMS + q] = atoms.dims[q];
  }
  if (tid < JD) prm[tid] = ss[(size_t)tid * B + b];
  if (tid < atoms.J) {
    prm[MAX_MATS + tid] = vs[(size_t)tid * B + b];
    prm[MAX_MATS + MAX_ATOMS + tid] = als[(size_t)tid * B + b];
  }
  for (int i = tid; i < Np; i += TILE_THREADS) {
    ay[i] = i < N ? err[(size_t)b * N + i] : 0.0f;
    mk[i] = i < N ? (mask ? mask[(size_t)b * N + i] : 1.0f) : 0.0f;
  }
  __syncthreads();
  build_tiles(tiles, d2s, mk, prm, noise[b], N, T, atoms.J, atoms.combine);
  __syncthreads();

  // The factor, a = L^{-1} err and the log-det, one 32-column sub-panel a
  // step, three phases and three barriers a step (dense_nll.cu's loop).
  float ld = 0.0f;  // sum log diag L, kept by warp 0
  for (int k = 0; k < T; ++k) {
    const int base = SP * (k + 1);  // the first row and column after the sub-panel
    if (warp == 0) factor_step(tiles, Lt(k), dg, yd, lt, k, N, ld);  // (a)
    __syncthreads();

    {  // (b): the rows below the sub-panel and err's row, a thread each
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
    __syncthreads();

    // (c): two units a tile pair (R, S), k < S <= R, enumerated row by row,
    // then err's row.
    const int n = T - k - 1, units = n * (n + 1) + 1;
    for (int u = warp; u < units; u += TILE_THREADS / 32) {
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

  // a and nll = ½‖a‖² + Σ log diag L + ½ N log 2π.
  float quad = 0.0f;
  for (int i = tid; i < N; i += TILE_THREADS) {
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
    for (int w = 0; w < TILE_THREADS / 32; ++w) total += red[w];
    nll[b] = 0.5f * total + ld + (float)(0.5 * N * 1.8378770664093453);
  }
}

template <bool WITH_W>
static cudaError_t configure_tiles() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(stationary_nll_tile_kernel<WITH_W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)(smem_floats(MAX_TILE_N, WITH_W) * sizeof(float)));
  if (e == cudaSuccess) configured = true;
  return e;
}

template <bool WITH_W>
static cudaError_t launch_tiles(const float* d2s, const float* err, const float* mask,
                                const float* vs, const float* ss, const float* als,
                                const float* noise, float* nll, float* a_out, float* W, int B,
                                int N, const Atoms& atoms, cudaStream_t stream) {
  cudaError_t e = configure_tiles<WITH_W>();
  if (e != cudaSuccess) return e;
  stationary_nll_tile_kernel<WITH_W>
      <<<B, TILE_THREADS, smem_floats(N, WITH_W) * sizeof(float), stream>>>(
          d2s, err, mask, vs, ss, als, noise, nll, a_out, W, B, N, atoms);
  return cudaGetLastError();
}

// -- the column loop (N > 256) --------------------------------------------

__device__ __forceinline__ size_t tri(int i) { return (size_t)i * (i + 1) / 2; }

template <bool WITH_W>
__global__ void __launch_bounds__(THREADS) stationary_nll_kernel(
    const float* __restrict__ d2s,    // (JD, N, N)
    const float* __restrict__ err,    // (B, N)
    const float* __restrict__ mask,   // (B, N) or null for all ones
    const float* __restrict__ vs,     // (J, B)
    const float* __restrict__ ss,     // (JD, B), s = 1/ℓ²
    const float* __restrict__ als,    // (J, B)
    const float* __restrict__ noise,  // (B,)
    float* __restrict__ nll,          // (B,)
    float* __restrict__ a_out,        // (B, N)
    float* __restrict__ W,            // (B, N, N) when WITH_W
    float* __restrict__ workspace,    // (B, N(N+1)/2) or null: factor in shared memory
    int B, int N, Atoms atoms) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t NN = (size_t)N * N;

  float* a = smem;        // N: err, then L^{-1} err
  float* col = a + N;     // N: column k of L, scaled
  float* red = col + N;   // 32: block reduction
  float* L = workspace ? workspace + (size_t)b * tri(N) : red + 32;
  float* Wb = WITH_W ? W + (size_t)b * NN : nullptr;

  // 1. Build the packed lower triangle of K_b.
  const float nz = noise[b];
  for (size_t t = tid; t < NN; t += blockDim.x) {
    const int i = (int)(t / N);
    const int j = (int)(t - (size_t)i * N);
    if (j > i) continue;
    float E = atoms.combine ? 1.0f : 0.0f;
    int off = 0;
    for (int q = 0; q < atoms.J; ++q) {
      float U = 0.0f;
      for (int d = 0; d < atoms.dims[q]; ++d)
        U += ss[(size_t)(off + d) * B + b] * d2s[(size_t)(off + d) * NN + t];
      off += atoms.dims[q];
      const float term = vs[(size_t)q * B + b] * phi(atoms.family[q], U, als[(size_t)q * B + b]);
      E = atoms.combine ? E * term : E + term;
    }
    const float mi = mask ? mask[(size_t)b * N + i] : 1.0f;
    const float mj = mask ? mask[(size_t)b * N + j] : 1.0f;
    float k = (mi * mj) * E;
    if (i == j) k += mi * nz + (1.0f - mi);
    L[tri(i) + j] = k;
  }
  for (int i = tid; i < N; i += blockDim.x) a[i] = err[(size_t)b * N + i];
  if (WITH_W)
    for (size_t t = tid; t < NN; t += blockDim.x) Wb[t] = (t / N == t % N) ? 1.0f : 0.0f;
  __syncthreads();

  // 2. Right-looking Cholesky with the solve, log-det and inverse fused.
  float logdet = 0.0f;
  for (int k = 0; k < N; ++k) {
    const float d = sqrtf(L[tri(k) + k]);
    const float ak = a[k] / d;
    __syncthreads();  // every thread has read the pivot and a[k]
    for (int i = k + 1 + tid; i < N; i += blockDim.x) {
      const float l = L[tri(i) + k] / d;
      L[tri(i) + k] = l;
      col[i] = l;
      a[i] -= l * ak;
    }
    if (tid == 0) {
      L[tri(k) + k] = d;
      a[k] = ak;
      logdet += logf(d);
    }
    if (WITH_W)
      for (int c = tid; c <= k; c += blockDim.x) Wb[(size_t)k * N + c] /= d;
    __syncthreads();  // column k and row k of W are final
    for (int i = k + 1 + warp; i < N; i += nwarps) {
      const float li = col[i];
      float* Li = L + tri(i);
      for (int j = k + 1 + lane; j <= i; j += 32) Li[j] -= li * col[j];
    }
    if (WITH_W) {
      const float* Wk = Wb + (size_t)k * N;
      for (int r = k + 1 + warp; r < N; r += nwarps) {
        const float lr = col[r];
        float* Wr = Wb + (size_t)r * N;
        for (int c = lane; c <= k; c += 32) Wr[c] -= lr * Wk[c];
      }
    }
    __syncthreads();  // trailing block updated
  }

  // 3. Outputs: a, and nll = ½‖a‖² + Σ log d + ½ N log 2π.
  float quad = 0.0f;
  for (int i = tid; i < N; i += blockDim.x) {
    const float ai = a[i];
    a_out[(size_t)b * N + i] = ai;
    quad += ai * ai;
  }
  for (int o = 16; o > 0; o >>= 1) quad += __shfl_xor_sync(0xffffffffu, quad, o);
  if (lane == 0) red[warp] = quad;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int w = 0; w < nwarps; ++w) total += red[w];
    nll[b] = 0.5f * total + logdet + (float)(0.5 * N * 1.8378770664093453);
  }
}

static int smem_optin() {
  static int bytes = -1;
  if (bytes < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes;
}

static size_t smem_bytes(int N, bool factor_in_smem) {
  size_t bytes = (size_t)(2 * N + 32) * sizeof(float);
  if (factor_in_smem) bytes += (size_t)N * (N + 1) / 2 * sizeof(float);
  return bytes;
}

// 1 if the packed factor of an N-row model does not fit shared memory and
// the caller must pass a workspace of B·N(N+1)/2 floats.
extern "C" int stationary_nll_needs_workspace(int N) {
  return smem_bytes(N, true) > (size_t)smem_optin() ? 1 : 0;
}

template <bool WITH_W>
static cudaError_t launch(const float* d2s, const float* err, const float* mask,
                          const float* vs, const float* ss, const float* als,
                          const float* noise, float* nll, float* a_out, float* W,
                          float* workspace, int B, int N, const Atoms& atoms,
                          cudaStream_t stream) {
  const size_t bytes = smem_bytes(N, workspace == nullptr);
  if (bytes > (size_t)smem_optin()) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(stationary_nll_kernel<WITH_W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
  }
  stationary_nll_kernel<WITH_W><<<B, THREADS, bytes, stream>>>(
      d2s, err, mask, vs, ss, als, noise, nll, a_out, W, workspace, B, N, atoms);
  return cudaGetLastError();
}

static long long g_launches[2];  // the tile kernel's, the column loop's

// Plain C entry point: every pointer is a device pointer except `families`
// and `dims` (host arrays of J ints). N <= 256 runs the tile kernel (the
// workspace is not used), larger N the column loop. Returns the cudaError_t
// of the launch.
extern "C" int stationary_nll_launch(const float* d2s, const float* err,
                                     const float* mask, const float* vs,
                                     const float* ss, const float* als,
                                     const float* noise, float* nll, float* a_out,
                                     float* W, float* workspace, int B, int N, int J,
                                     const int* families, const int* dims,
                                     int combine, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (J < 1 || J > MAX_ATOMS) return (int)cudaErrorInvalidValue;
  Atoms atoms;
  atoms.J = J;
  atoms.combine = combine;
  int jd = 0;
  for (int q = 0; q < J; ++q) {
    atoms.family[q] = families[q];
    atoms.dims[q] = dims[q];
    jd += dims[q];
  }
  if (jd > MAX_MATS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool tiled = N <= MAX_TILE_N;
  cudaError_t e;
  if (tiled)
    e = W ? launch_tiles<true>(d2s, err, mask, vs, ss, als, noise, nll, a_out, W, B, N, atoms, s)
          : launch_tiles<false>(d2s, err, mask, vs, ss, als, noise, nll, a_out, W, B, N, atoms,
                                s);
  else
    e = W ? launch<true>(d2s, err, mask, vs, ss, als, noise, nll, a_out, W, workspace, B, N,
                         atoms, s)
          : launch<false>(d2s, err, mask, vs, ss, als, noise, nll, a_out, W, workspace, B, N,
                          atoms, s);
  if (e == cudaSuccess) ++g_launches[tiled ? 0 : 1];
  return (int)e;
}

// Launches since the library was loaded: out[0] of the tile kernel, out[1]
// of the column loop.
extern "C" void stationary_nll_kernel_launches(long long* out) {
  out[0] = g_launches[0];
  out[1] = g_launches[1];
}

// CTAs of the kernel that runs at this N resident on one SM at once
// (occupancy), or -1 on error.
extern "C" int stationary_nll_ctas_per_sm(int N, int with_w) {
  if (N <= 0) return -1;
  int n = -1;
  cudaError_t e;
  if (N <= MAX_TILE_N) {
    const size_t bytes = smem_floats(N, with_w) * sizeof(float);
    e = with_w ? configure_tiles<true>() : configure_tiles<false>();
    if (e != cudaSuccess) return -1;
    e = with_w ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, stationary_nll_tile_kernel<true>, TILE_THREADS, bytes)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, stationary_nll_tile_kernel<false>, TILE_THREADS, bytes);
  } else {
    const size_t bytes = smem_bytes(N, !stationary_nll_needs_workspace(N));
    if (with_w) {
      e = cudaFuncSetAttribute(stationary_nll_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, stationary_nll_kernel<true>,
                                                          THREADS, bytes);
    } else {
      e = cudaFuncSetAttribute(stationary_nll_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, stationary_nll_kernel<false>,
                                                          THREADS, bytes);
    }
  }
  return e == cudaSuccess ? n : -1;
}
