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
// Two kernels, chosen by N at the entry point (N > 512 is refused: the
// router's fused window ends there):
//
// N <= 256: the tile kernel (stationary_nll_tile_kernel), csrc/dense_nll.cu's
// design on the tile core it shares with it (nll_tile.cuh): 256 threads, the
// lower triangle of K_b padded to Np = 32 T with an identity block as
// T (T + 1) / 2 tiles of 32 x 32 (36-float rows) in shared memory, factored
// in 32-column sub-panels by a warp factor, row solves (err rides along as
// one more row) and rank-32 updates, three barriers a sub-panel; with the
// flag, W formed after the factor a column per thread and written once, in
// coalesced rows. The one difference from the dense kernel is that K_b is
// built here, straight into the tiles, as the TPU kernel builds it on the
// chip, in place of dense_nll.cu's copy of a prebuilt K: each entry in
// build_general_plain's order of operations, masked rows as identity rows.
// The d2 matrices are shared by the batch and read through L2 by every CTA;
// a warp reads 32 consecutive floats of a d2 row, and a thread issues the
// loads of 8 entries (2 tiles) before it uses any, so that one L2 round
// trip serves 8 entries, and evaluates φ in one family's code, chosen once
// per atom (build_tiles). Rounding is the JAX kernel's (chol_tile.cuh: sqrt
// and division correctly rounded). Shared memory is dense_nll.cu's layout
// (205,952 B at N = 256 with W, 177,280 B without); the mask and the
// model's parameters sit in the factor's scratch until the build is done.
// Registers: 255 a thread (about 50 B of spills), one CTA an SM; B = 128 is
// one wave on 132 SMs.
//
// 256 < N <= 512 (frontier grid A's 262, a walk-forward on a one- to
// two-year window, the NUTS posterior's 512): the cluster kernel
// (stationary_nll_cluster_kernel), the same tiles, T = 9 .. 16, spread over
// a thread-block cluster of C CTAs per model whose shared memory the CTAs
// read and write through the cluster's window (DSMEM): tile row R lives in
// rank R mod C, which builds its tiles of K_b itself (build_tiles on its
// rows), so the factor stays on chip at every N of the window. Sub-panel k
// takes three phases and two cluster barriers:
//   (a) the owner of tile row k factors the diagonal tile (factor_diagonal)
//       and writes its transpose, diagonal and estimates into every rank;
//   (b) every rank solves its rows below the sub-panel (and the owner of k
//       err's block k) and writes each solved row into the panel buffer of
//       every rank (and err's block into every rank's copy of a);
//   (c) every rank applies the rank-32 updates to its own trailing tiles
//       (update_half) and to its blocks of a, from its local panel only:
//       the inner loop touches no remote memory.
// With the flag, W = L^{-1} is split by columns once L is final: rank r
// forms tile columns r, r + C, ..., a column per thread (form_inverse's
// scheme), g warps on each (the largest power of two that the rank's 8
// warps hold), which split the tile products of each row block J with W's
// earlier row blocks and meet through shared memory before the solve; for
// each row block J every rank copies L's tiles (J, r .. J - 1) and the
// transposed diagonal tile from their owner into its panel buffer. A
// column's earlier row blocks of W are read back from W itself in global
// memory (L2-resident), so the shared memory holds L and nothing of W.
// Shared memory a CTA (the largest rank's tiles, the panel of T - 1 tiles,
// a transpose, scratch, three Np vectors and the inverse's partial sums;
// the same layout in every rank) sets C: the smallest of 2, 4 and 8 that
// fits the 232,448 B a block may use, C = 2 up to T = 11 (N = 352), 4 up to
// 14 (448), 8 above. C, and with it g and the order in which a column's
// partial sums are added, depends on N alone: a model's a and W round the
// same whatever the batch beside it. 256 threads, one CTA an SM.
//
// Bound on an H100 (SXM, 700 W): per model N^3/3 flops of factor plus N^3/3
// of inverse. At B = 128, N = 256 with W that is 1.4 GFLOP of fp32 (~21 us
// at 67 TFLOP/s) against 34 MB of W written (~10 us at 3.35 TB/s):
// operations bound; at (20, 262) 0.0036 ms and at the NUTS posterior's
// (8, 512) with W (ARD, 4 d2 matrices) 0.0109 ms, also operations
// (chip_smoke.nll_bound_ms). Neither kernel comes near it: at the walk-forward
// shape (B = 5, N = 77) five CTAs occupy 5 of 132 SMs and the time is the
// latency of the chain: the warp factors of 32 dependent pivots, their row
// solves, the inverse's last row blocks (tools/kernel_timeline.py); above
// 256 the cluster's T warp factors, 2 T cluster barriers and the longest
// column tile of W (T (T - 1) / 2 tile products over its g warps) set the
// pace.
//
// The backward (stationary_nll_grad_alpha, then stationary_nll_grad_kernel;
// its note is at the kernels) turns the forward's W and a into the
// hyperparameters' gradients without writing a (B, N, N) tensor.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "chol_tile.cuh"
#include "hopper_async.cuh"
#include "nll_tile.cuh"

namespace cg = cooperative_groups;

#define MAX_ATOMS 8
#define MAX_MATS 32
#define TILE_THREADS 256  // both kernels: a warp per tile column (nll_tile.cuh)
#define MAX_TILE_N 256    // the tile kernel's N (T <= 8 tiles); the cluster kernel above it
#define MAX_N 512         // the cluster kernel's N (T <= 16 tiles)
#define MAX_T (MAX_N / SP)
#define MAX_CLUSTER 8     // the portable cluster size
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

// Build ntiles tiles of K_b (rows past N: an identity block) in shared
// memory: the tile rows R0, R0 + dR, ..., each from S = 0 to R, stored in
// that order (the tile kernel: R0 = 0, dR = 1, all T (T + 1) / 2 tiles; the
// cluster kernel: a rank's rows). Warp w builds rows w, w + 8, w + 16 and w + 24 of each tile,
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
// (MAX_ATOMS ints each). Each entry is build_general_plain's, in its order
// of operations; zeros above the diagonal.
__device__ __noinline__ void build_tiles(float* tiles, const float* __restrict__ d2s,
                                            const float* mk, const float* prm, float nz, int N,
                                            int R0, int dR, int ntiles, int J, int prod) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t NN = (size_t)N * N;
  const float* sv = prm;
  const float* vv = prm + MAX_MATS;
  const float* av = vv + MAX_ATOMS;
  const int* fams = reinterpret_cast<const int*>(av + MAX_ATOMS);
  const int* dims = fams + MAX_ATOMS;
  int R = R0, S = 0;  // the tile (R, S) that the next group starts with
  for (int t0 = 0; t0 < ntiles; t0 += GROUP) {
    int Rg[GROUP], Sg[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      Rg[g] = R, Sg[g] = S;
      if (++S > R) R += dR, S = 0;
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

// Model b's operands into shared memory for build_tiles: prm (its s, v and
// α, the atoms' families and d2 counts), mk (the mask, zeros past N) and
// ay (err, zeros past N). The atoms' fields by constant indices (an index
// known only at run time would copy the struct to local memory), the
// model's parameters by thread.
__device__ __forceinline__ void stage_model(float* prm, float* mk, float* ay,
                                            const float* __restrict__ err,
                                            const float* __restrict__ mask,
                                            const float* __restrict__ vs,
                                            const float* __restrict__ ss,
                                            const float* __restrict__ als, int B, int b, int N,
                                            int Np, const Atoms& atoms) {
  const int tid = threadIdx.x;
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

  stage_model(prm, mk, ay, err, mask, vs, ss, als, B, b, N, Np, atoms);
  __syncthreads();
  build_tiles(tiles, d2s, mk, prm, noise[b], N, 0, 1, T * (T + 1) / 2, atoms.J, atoms.combine);
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

// -- the cluster kernel (256 < N <= 512) ------------------------------------

// Tiles of L that rank `rank` of a C-CTA cluster holds: tile rows rank,
// rank + C, ... below T, each from S = 0 to R.
__host__ __device__ __forceinline__ int own_tiles(int T, int C, int rank) {
  int n = 0;
  for (int R = rank; R < T; R += C) n += R + 1;
  return n;
}

// Index of tile (R, S) among the tiles of R's owner `rank`, row by row.
__device__ __forceinline__ int own_index(int R, int S, int rank, int C) {
  const int i = (R - rank) / C;
  return i * (rank + 1) + C * i * (i - 1) / 2 + S;
}

// The tile columns of W that rank `rank` forms: rank, rank + C, ... below T.
__host__ __device__ __forceinline__ int own_columns(int T, int C, int rank) {
  return (T - 1 - rank) / C + 1;
}

// Warps on each of n tile columns of W: the largest power of two g with
// g n <= 8 warps, and at most G.
__host__ __device__ __forceinline__ int warps_per_column(int n, int G) {
  int g = 1;
  while (2 * g * n <= TILE_THREADS / 32 && 2 * g <= G) g *= 2;
  return g;
}

// The cluster kernel's shared memory in floats from its base, the same in
// every rank (so that a peer's buffer is at the same offset as one's own).
struct ClusterLayout {
  int panel;  // T - 1 tiles: (S, k) in slot S - 1; the inverse's row block of L
  int ltc;    // SP x SP: the current diagonal tile of L transposed
  int ay;     // Np: err, then a = L^{-1} err (own blocks, and every block once solved)
  int dg;     // Np: diag L
  int yd;     // Np: the estimates of 1 / diag L
  int lt;     // SP x SP: (a)'s scratch; the mask and the atoms until K is built
  int red;    // 32: block reduction
  int lds;    // MAX_T: Σ log diag of each diagonal tile (read in rank 0)
  int part;   // (g - 1) SP x SP a tile column of W: the inverse's partial sums
  int total;
};

// The layout at T tiles, C ranks and at most G warps a tile column of W.
__host__ __device__ __forceinline__ ClusterLayout cluster_layout(int T, int C, int G) {
  int most = 0, parts = 0;
  for (int r = 0; r < C; ++r) {
    const int n = own_tiles(T, C, r), nc = own_columns(T, C, r);
    const int p = (warps_per_column(nc, G) - 1) * nc;
    most = n > most ? n : most;
    parts = p > parts ? p : parts;
  }
  ClusterLayout l;
  l.panel = most * TILE;
  l.ltc = l.panel + (T - 1) * TILE;
  l.ay = l.ltc + SP * SP;
  l.dg = l.ay + SP * T;
  l.yd = l.dg + SP * T;
  l.lt = l.yd + SP * T;
  l.red = l.lt + SP * SP;
  l.lds = l.red + 32;
  l.part = l.lds + MAX_T;
  l.total = l.part + parts * SP * SP;
  return l;
}

// nll_tile.cuh's product with W's entries of column c in row block S
// already in registers (w): the same operations in the same order.
__device__ __forceinline__ void product_regs(float (&x)[SP], const float (&w)[SP],
                                             const float* Lt, int m0) {
#pragma unroll
  for (int m = 0; m < SP; m += 4) {
#pragma unroll
    for (int rr = 0; rr < SP; ++rr) {
      const float4 v = *reinterpret_cast<const float4*>(Lt + rr * LDT + m);
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float t = fmaf(-vs[u], w[m + u], x[rr]);
        x[rr] = m + u >= m0 ? t : x[rr];
      }
    }
  }
}

// Column c of W's row block S (rows 32 S .. 32 S + 31 < N) from W in global
// memory: Wc points at W_b's column c. Row block S was written by warp 0 of
// the column's g warps (the same thread where g = 1); the __syncthreads that
// ends row block S makes it visible to the column's other warps.
__device__ __forceinline__ void load_w(float (&w)[SP], const float* Wc, int S, int N) {
#pragma unroll
  for (int m = 0; m < SP; ++m) w[m] = Wc[(size_t)(SP * S + m) * N];
}

template <bool WITH_W>
__global__ void __launch_bounds__(TILE_THREADS, 1) stationary_nll_cluster_kernel(
    const float* __restrict__ d2s,    // (JD, N, N)
    const float* __restrict__ err,    // (B, N)
    const float* __restrict__ mask,   // (B, N) or null for all ones
    const float* __restrict__ vs,     // (J, B)
    const float* __restrict__ ss,     // (JD, B), s = 1/ℓ²
    const float* __restrict__ als,    // (J, B)
    const float* __restrict__ noise,  // (B,)
    float* __restrict__ nll,          // (B,)
    float* __restrict__ a_out,        // (B, N)
    float* W,                         // (B, N, N) when WITH_W; read back by its writer
    int B, int N, int C, int G, Atoms atoms) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), b = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = (N + SP - 1) / SP, Np = SP * T;
  const ClusterLayout ly = cluster_layout(T, C, G);
  float* tiles = smem;  // this rank's tiles of K, then L (own_index)
  float* panel = smem + ly.panel;
  float* ltc = smem + ly.ltc;
  float* ay = smem + ly.ay;
  float* dg = smem + ly.dg;
  float* yd = smem + ly.yd;
  float* lt = smem + ly.lt;
  float* red = smem + ly.red;
  float* lds = smem + ly.lds;
  // the same buffer in rank q's shared memory
  auto at = [&](float* p, int q) { return cluster.map_shared_rank(p, (unsigned)q); };

  stage_model(lt + MAX_N, lt, ay, err, mask, vs, ss, als, B, b, N, Np, atoms);
  __syncthreads();
  build_tiles(tiles, d2s, lt, lt + MAX_N, noise[b], N, rank, C, own_tiles(T, C, rank), atoms.J,
              atoms.combine);
  cluster.sync();  // every rank has started and built its tiles

  for (int k = 0; k < T; ++k) {
    const int owner = k % C;
    if (rank == owner && warp == 0) {  // (a)
      float* D = tiles + own_index(k, k, rank, C) * TILE;
      const float s = factor_diagonal<LDT>(D, dg + SP * k, yd + SP * k, lt, N - SP * k);
      float x[SP];
      load_row(x, D + lane * LDT);
      const float dl = dg[SP * k + lane], yl = yd[SP * k + lane];
      for (int q = 0; q < C; ++q) {
        float* Lq = at(ltc, q);
#pragma unroll
        for (int c = 0; c < SP; ++c) Lq[c * SP + lane] = x[c];
        at(dg, q)[SP * k + lane] = dl;
        at(yd, q)[SP * k + lane] = yl;
      }
      if (lane == 0) at(lds, 0)[k] = s;
    }
    cluster.sync();

    // (b): this rank's rows below the sub-panel (its tile rows R1, R1 + C,
    // ...), a thread each, and in the owner err's block k; each solved row
    // goes to every rank's panel (err's block to every rank's a).
    int R1 = rank;
    while (R1 <= k) R1 += C;
    const int nrows = R1 < T ? SP * ((T - 1 - R1) / C + 1) : 0;
    const int solves = nrows + (rank == owner ? 1 : 0);
    for (int u = tid; u < solves; u += TILE_THREADS) {
      const bool e = u == nrows;
      const int R = R1 + (u / SP) * C, m = u % SP;
      float* row = e ? ay + SP * k : tiles + own_index(R, k, rank, C) * TILE + m * LDT;
      float r[SP];
      load_row(r, row);
      solve(r, ltc, dg + SP * k, yd + SP * k, 0);
      store_row(row, r);
      for (int q = 0; q < C; ++q) {
        if (!e)
          store_row(at(panel, q) + (R - 1) * TILE + m * LDT, r);
        else if (q != rank)
          store_row(at(ay, q) + SP * k, r);
      }
    }
    cluster.sync();

    // (c): two units a pair (R, S) of this rank's trailing tiles, k < S <= R,
    // enumerated row by row, then one for its blocks of a; local memory only.
    int pairs = 0;
    for (int R = R1; R < T; R += C) pairs += R - k;
    const int units = 2 * pairs + (nrows > 0 ? 1 : 0);
    for (int u = warp; u < units; u += TILE_THREADS / 32) {
      if (u == 2 * pairs) {  // a[j] -= sum_m a[32 k + m] L(j, 32 k + m), j in this rank's rows
        const float4* ak = reinterpret_cast<const float4*>(ay + SP * k);
        for (int j = lane; j < nrows; j += 32) {
          const int R = R1 + (j / SP) * C, m = j % SP;
          const float4* Lj = reinterpret_cast<const float4*>(panel + (R - 1) * TILE + m * LDT);
          float s = 0.0f;
#pragma unroll
          for (int q = 0; q < SP / 4; ++q) {
            const float4 v = Lj[q], w = ak[q];
            s = fmaf(v.x, w.x, s);
            s = fmaf(v.y, w.y, s);
            s = fmaf(v.z, w.z, s);
            s = fmaf(v.w, w.w, s);
          }
          ay[SP * R + m] -= s;
        }
        continue;
      }
      int p = u >> 1, R = R1;
      while (p >= R - k) p -= R - k, R += C;
      const int S = k + 1 + p;
      update_half(tiles + own_index(R, S, rank, C) * TILE, panel + (R - 1) * TILE,
                  panel + (S - 1) * TILE, u & 1);
    }
    // the next diagonal tile's owner factors it from its own updates; the
    // other ranks meet the next cluster barrier first
    if (rank == (k + 1) % C) __syncthreads();
  }

  if (WITH_W) {
    // W = L^{-1} by columns: the rank's tile columns Jc = rank + i C, i < nc,
    // g warps each; warp w takes tile column i = w / g, its thread c column
    // c. Row block J of L comes from its owner, the tiles (J, rank .. J - 1)
    // into the panel and (J, J) transposed into ltc. The g warps of a column
    // split the products with W's earlier row blocks S (warp q takes S = Jc +
    // q, Jc + q + g, ...); the first adds the others' sums (through `part`,
    // in the order of q) and solves against the diagonal tile.
    const int nc = own_columns(T, C, rank), g = warps_per_column(nc, G);
    const int i = warp / g, q = warp % g, Jc = rank + i * C, c = SP * Jc + lane;
    const bool mine = i < nc && c < N;
    float* Wc = W + (size_t)b * N * N + c;
    // column c's row rr of warp p's sum at part[((p - 1) SP + rr) SP]
    float* part = smem + ly.part + i * (g - 1) * SP * SP + lane;
    for (int J = 0; J < T; ++J) {
      if (J >= rank) {
        const int src_rank = J % C, n = (J - rank + 1) * SP * SP / 4;
        const float* src = at(tiles, src_rank);
        for (int q0 = tid; q0 < n; q0 += 4 * TILE_THREADS) {
          float4 v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = q0 + e * TILE_THREADS, s = t >> 8, m = (t >> 3) & 31, c4 = t & 7;
            if (t < n)
              v[e] = *reinterpret_cast<const float4*>(
                  src + own_index(J, rank + s, src_rank, C) * TILE + m * LDT + 4 * c4);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = q0 + e * TILE_THREADS, s = t >> 8, m = (t >> 3) & 31, c4 = t & 7;
            if (t >= n) continue;
            if (rank + s < J) {
              *reinterpret_cast<float4*>(panel + s * TILE + m * LDT + 4 * c4) = v[e];
            } else {
              ltc[(4 * c4) * SP + m] = v[e].x;
              ltc[(4 * c4 + 1) * SP + m] = v[e].y;
              ltc[(4 * c4 + 2) * SP + m] = v[e].z;
              ltc[(4 * c4 + 3) * SP + m] = v[e].w;
            }
          }
        }
      }
      __syncthreads();
      float x[SP];
#pragma unroll
      for (int rr = 0; rr < SP; ++rr) x[rr] = q == 0 && SP * J + rr == c ? 1.0f : 0.0f;
      if (mine && J >= Jc) {
        float w[SP];
        if (Jc + q < J) load_w(w, Wc, Jc + q, N);
        for (int S = Jc + q; S < J; S += g) {
          float wn[SP];
          if (S + g < J) load_w(wn, Wc, S + g, N);  // in flight during the product
          product_regs(x, w, panel + (S - rank) * TILE, S == Jc ? lane : 0);
#pragma unroll
          for (int m = 0; m < SP; ++m) w[m] = wn[m];
        }
        if (q > 0) {
#pragma unroll
          for (int rr = 0; rr < SP; ++rr) part[((q - 1) * SP + rr) * SP] = x[rr];
        }
      }
      if (g > 1) __syncthreads();
      if (mine && q == 0) {
        if (J >= Jc) {
          for (int p = 1; p < g; ++p) {
#pragma unroll
            for (int rr = 0; rr < SP; ++rr) x[rr] += part[((p - 1) * SP + rr) * SP];
          }
          solve(x, ltc, dg + SP * J, yd + SP * J, J == Jc ? lane : 0);
        }
#pragma unroll
        for (int rr = 0; rr < SP; ++rr)
          if (SP * J + rr < N) Wc[(size_t)(SP * J + rr) * N] = x[rr];  // 0 above the diagonal
      }
      __syncthreads();  // the panel, ltc and part are read before the next row block's copy
    }
    cluster.sync();  // no rank leaves while a peer still reads its tiles
  }

  // a and nll = ½‖a‖² + Σ log diag L + ½ N log 2π, in rank 0, which holds
  // every block of a and every diagonal tile's log sum.
  if (rank == 0) {
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
      float total = 0.0f, ld = 0.0f;
      for (int w = 0; w < TILE_THREADS / 32; ++w) total += red[w];
      for (int k = 0; k < T; ++k) ld += lds[k];
      nll[b] = 0.5f * total + ld + (float)(0.5 * N * 1.8378770664093453);
    }
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

template <bool WITH_W>
static cudaError_t configure_cluster() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(stationary_nll_cluster_kernel<WITH_W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
  if (e == cudaSuccess) configured = true;
  return e;
}

// A shape of the cluster kernel: C CTAs a model, G warps at most a tile
// column of W, the shared bytes a CTA (C = -1: it does not fit).
struct ClusterShape {
  int C, G;
  size_t bytes;
};

// At T tiles and C ranks: G the most of 8, 4, 2 and 1 whose partial sums fit
// beside the largest rank's tiles in a block's shared memory.
static ClusterShape shape_at(int T, int C) {
  const size_t most = (size_t)smem_optin();
  auto bytes = [&](int G) { return (size_t)cluster_layout(T, C, G).total * sizeof(float); };
  if (bytes(1) > most) return {-1, 1, 0};
  int G = TILE_THREADS / 32;
  while (G > 1 && bytes(G) > most) G /= 2;
  return {C, G, bytes(G)};
}

// The launch of B clusters of the shape (attr: the cluster's dimension).
static cudaLaunchConfig_t cluster_launch(int B, const ClusterShape& sh,
                                         cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * sh.C, 1, 1);
  cfg.blockDim = dim3(TILE_THREADS, 1, 1);
  cfg.dynamicSmemBytes = sh.bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster kernel's shape at N: the smallest C of 2, 4 and 8 whose
// largest rank's tiles fit (C = -1 where none does). It depends on N alone,
// so that a model's rounding does not depend on the batch beside it.
static ClusterShape cluster_shape(int N) {
  const int T = (N + SP - 1) / SP;
  ClusterShape sh = {-1, 1, 0};
  for (int C = 2; C <= MAX_CLUSTER && sh.C < 0; C *= 2) sh = shape_at(T, C);
  return sh;
}

template <bool WITH_W>
static cudaError_t launch_cluster(const float* d2s, const float* err, const float* mask,
                                  const float* vs, const float* ss, const float* als,
                                  const float* noise, float* nll, float* a_out, float* W, int B,
                                  int N, const Atoms& atoms, cudaStream_t stream) {
  const ClusterShape sh = cluster_shape(N);
  if (sh.C < 0) return cudaErrorInvalidValue;
  cudaError_t e = configure_cluster<WITH_W>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_launch(B, sh, attr, stream);
  e = cudaLaunchKernelEx(&cfg, stationary_nll_cluster_kernel<WITH_W>, d2s, err, mask, vs, ss,
                         als, noise, nll, a_out, W, B, N, sh.C, sh.G, atoms);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// -- the backward (256 threads at most; N <= 512) ---------------------------
//
// The closed-form gradient of the NLL (GPML 5.9) from the forward's W = L^{-1}
// and a = L^{-1} err, for a cotangent g of the B NLLs, in place of the torch
// closed form of ops/stationary_nll.py (the JAX package leaves this backward
// to XLA; no TPU kernel is replaced):
//   K^{-1} = W^T W,  alpha = W^T a,  T = 1/2 g (m m^T) o (K^{-1} - alpha alpha^T),
//   dv_j = sum T dK/dv_j,  ds_{j,d} = sum T dK/du_j d2_{j,d},  dalpha_j = sum T dK/dalpha_j,
//   dnoise = sum_i m_i 1/2 g (K^{-1} - alpha alpha^T)_ii,  derr = g alpha,
// each sum over the whole (N, N) matrix, for the sum or the product of the
// atoms (_GeneralNLL.backward; the single-family path is J = 1). Nothing of
// size (B, N, N) is written: K^{-1} lives in registers, a tile at a time.
//
// Two launches. stationary_nll_grad_alpha forms alpha and derr: a CTA a
// model's 32-column block, 8 warps over the rows k >= the column, a lane a
// column, the warps' sums added in warp order. stationary_nll_grad_kernel
// does the rest, one CTA a unit: a model b, a tile row I and a group of G
// tile columns J (G = 4 from T = 4 tile rows on, fewer below), the
// lower-triangular tiles (I, J <= I) of K^{-1}. A unit streams W's rows k
// from 32 I to N (W_{k,i} = 0 for k < i) in 32-row stages through a
// three-stage cp.async ring: of each row, the group's live columns (below
// 32 (I + 1)) and, unless tile I is among them, tile I's 32, read from W's
// lower triangle only (4-byte copies: a row of W at odd N is not 16-byte
// aligned; the upper triangle and rows past N are zeros written to shared
// memory). 64 threads a tile, each a 4 x 4 block of K^{-1}_IJ in fp32
// registers (FFMA; no TF32), accumulate W_{k,I}^T W_{k,J} over the stream.
// The epilogue runs on those registers: T from alpha and the mask in their
// place, u_j from the block's d2 entries (shared by the batch, read through
// L2, the 16 loads of a matrix in flight together), phi, phi' and
// dphi/dalpha in each family's code (phi_of<F> of the forward and its
// derivatives), the sum or product rule and the products with d2, each
// summed over the block into the thread's sums; tiles below the diagonal
// count twice, diagonal tiles once. The unit's sums go, added in warp
// order, to its slot of a workspace; an integer arrival ticket picks the
// model's last CTA, which adds the U slots in unit order and writes dv, dl,
// dalpha and dnoise (no float atomics: a model's gradient has the same bits
// in any batch and in every run, since G, U and every order depend on N
// alone).
//
// Measured (graph replay, H100 80GB HBM3 at 700 W): 2.14 ms at (2560, 262)
// and 0.54 ms at (128, 512), of which the alpha launch 0.15 and 0.035,
// against 10.8 and 3.8 ms for the torch closed form (tools/grad_compare.py).
// What holds it back (kernel variants with parts cut out): at (2560, 262)
// 38,400 short CTAs, 4 stages each on average, pay the latency of their
// first loads, the ticket and the tail (~0.9 ms with neither product nor
// epilogue); the product (~0.64 ms, ~50% of the fp32 rate: two 16-byte
// shared loads a 16 FFMAs) and the epilogue (~0.47 ms) share the rest.
// A CTA that ran all of a model's units back to back (the ring running on
// across units) was slower (3.4 ms: its loop state spilled), as were 2 or 4
// ring stages and groups of 1 or 2 tiles; 16-row stages moved it by 5%.
//
// Bound on an H100 (SXM, 700 W): N^3/3 flops a model for W^T W (the
// epilogue is O(N^2)) and W's lower triangle read once: at (2560, 262) 1.53e10
// flops, 0.23 ms at 67 TFLOP/s, against 353 MB, 0.105 ms: operations; at
// (128, 512) 5.7e9 flops, 0.086 ms, against 67 MB: operations. The tiles
// pad N to 32 T and the diagonal tiles are computed whole (about 1.4x the
// operations at N = 262, 1.1x at 512).

#define GRAD_BK 32         // rows of W a stage of the ring holds
#define GRAD_STAGES 3      // stages of the ring
#define GRAD_MAX_UNITS 40  // a model's units at T = 16, G = 4
#define GRAD_ALPHA_THREADS 256

// dphi/du of family F at u, phi = phi_of<F>(u, al); mirrors stationary_nll._phi_prime.
template <int F>
__device__ __forceinline__ float dphi_of(float u, float al, float phi) {
  const float SQRT3 = 1.7320508075688772f;
  const float SQRT5 = 2.23606797749979f;
  const float PI = 3.141592653589793f;
  if (F == FAM_SE) return -0.5f * phi;
  if (F == FAM_RQ) return -0.5f * expf(-(al + 1.0f) * log1pf(u / (2.0f * al)));
  if (F == FAM_LINEAR) return 1.0f;
  const float r = sqrtf(fmaxf(u, 1e-20f));
  if (F == FAM_PERIODIC_SE) {  // the u -> 0 limit below 1e-12
    const float a2 = al * al;
    const float grad = -phi * PI * sinf(2.0f * PI * r) / (4.0f * a2 * r);
    return u > 1e-12f ? grad : -(PI * PI) * phi / (2.0f * a2);
  }
  if (F == FAM_MATERN12) return u > 1e-12f ? -expf(-r) / (2.0f * r) : 0.0f;  // 0 on the diagonal
  if (F == FAM_MATERN32) return -1.5f * expf(-SQRT3 * r);
  return -(5.0f / 6.0f) * (1.0f + SQRT5 * r) * expf(-SQRT5 * r);
}

// dphi/dalpha of family F at u (zero for the alpha-free families); mirrors
// stationary_nll._phi_dalpha.
template <int F>
__device__ __forceinline__ float dalpha_of(float u, float al, float phi) {
  if (F == FAM_RQ) {
    const float w = u / (2.0f * al);
    return phi * (w / (1.0f + w) - log1pf(w));
  }
  if (F == FAM_PERIODIC_SE) {
    const float sine = sinf(3.141592653589793f * sqrtf(fmaxf(u, 0.0f)));
    return phi * sine * sine / (al * al * al);
  }
  return 0.0f;
}

__host__ __device__ __forceinline__ bool has_alpha(int family) {
  return family == FAM_RQ || family == FAM_PERIODIC_SE;
}

// phi of family F at the 4 entries of a row of a thread's block and, with
// D, phi' and dphi/dalpha.
template <int F, bool D>
__device__ __forceinline__ void family4(const float (&u)[4], float al, float (&p)[4],
                                        float (&dp)[4], float (&da)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    p[e] = phi_of<F>(u[e], al);
    if (D) dp[e] = dphi_of<F>(u[e], al, p[e]), da[e] = dalpha_of<F>(u[e], al, p[e]);
  }
}

// family4 with the family chosen at run time (the same in every thread).
template <bool D>
__device__ __forceinline__ void atom4(int fam, const float (&u)[4], float al, float (&p)[4],
                                      float (&dp)[4], float (&da)[4]) {
  switch (fam) {
    case FAM_SE: family4<FAM_SE, D>(u, al, p, dp, da); break;
    case FAM_MATERN12: family4<FAM_MATERN12, D>(u, al, p, dp, da); break;
    case FAM_MATERN32: family4<FAM_MATERN32, D>(u, al, p, dp, da); break;
    case FAM_MATERN52: family4<FAM_MATERN52, D>(u, al, p, dp, da); break;
    case FAM_RQ: family4<FAM_RQ, D>(u, al, p, dp, da); break;
    case FAM_PERIODIC_SE: family4<FAM_PERIODIC_SE, D>(u, al, p, dp, da); break;
    default: family4<FAM_LINEAR, D>(u, al, p, dp, da); break;
  }
}

// The 16 entries (i0 + t / 4, j0 + t % 4) of an N x N matrix M whose bits
// in okm are set (zeros elsewhere), their loads in flight together.
__device__ __forceinline__ void load16(float (&x)[16], const float* __restrict__ M, int i0,
                                       int j0, int N, unsigned okm) {
#pragma unroll
  for (int t = 0; t < 16; ++t)
    x[t] = (okm >> t) & 1u ? __ldg(M + (size_t)(i0 + (t >> 2)) * N + j0 + (t & 3)) : 0.0f;
}

// u = sum_d s_d d2_{off + d} at those entries.
__device__ __forceinline__ void arg16(float (&u)[16], const float* __restrict__ d2s, size_t NN,
                                      int i0, int j0, int N, unsigned okm, const float* sv,
                                      int off, int dq) {
#pragma unroll
  for (int t = 0; t < 16; ++t) u[t] = 0.0f;
  for (int d = 0; d < dq; ++d) {
    float x[16];
    load16(x, d2s + (size_t)(off + d) * NN, i0, j0, N, okm);
    const float s = sv[off + d];
#pragma unroll
    for (int t = 0; t < 16; ++t) u[t] += s * x[t];
  }
}

// A model's units: (tile row, group of G tile columns), heaviest first.
struct GradUnits {
  int U, G;
  unsigned char row[GRAD_MAX_UNITS], grp[GRAD_MAX_UNITS];
};

// The backward kernel's shared memory in floats: the ring (GRAD_STAGES
// stages of GRAD_BK rows of SP + SP G columns), which then holds the threads' sums
// (NQ x nt); alpha and the mask on the unit's rows and columns; the
// model's s, v, alpha and product of the v's; the atoms' families, d2
// counts and offsets and a flag (ints); the warps' sums and the totals.
struct GradLayout {
  int vec, prm, meta, red, total;
};

__host__ __device__ __forceinline__ GradLayout grad_layout(int G, int NQ, int nt) {
  const int ring = GRAD_STAGES * GRAD_BK * SP * (1 + G), sums = NQ * nt;
  GradLayout l;
  l.vec = ring > sums ? ring : sums;
  l.prm = l.vec + 2 * SP * (1 + G);
  l.meta = l.prm + MAX_MATS + 2 * MAX_ATOMS + 1;
  l.red = l.meta + 3 * MAX_ATOMS + 1;
  l.total = l.red + NQ * (nt / 32) + NQ;
  return l;
}

__global__ void __launch_bounds__(GRAD_ALPHA_THREADS) stationary_nll_grad_alpha(
    const float* __restrict__ W,  // (B, N, N), lower triangular
    const float* __restrict__ a,  // (B, N)
    const float* __restrict__ g,  // (B,)
    float* __restrict__ alpha,    // (B, N): W^T a
    float* __restrict__ derr,     // (B, N): g alpha
    int N) {
  __shared__ float red[GRAD_ALPHA_THREADS / 32][33];
  const int T = (N + SP - 1) / SP, b = blockIdx.x / T, Jc = blockIdx.x % T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = SP * Jc + lane;
  const float* Wb = W + (size_t)b * N * N;
  const float* ab = a + (size_t)b * N;
  float s = 0.0f;
  if (c < N) {
    for (int k = SP * Jc + warp; k < N; k += 4 * (GRAD_ALPHA_THREADS / 32)) {
      float w[4], x[4];  // four rows' loads in flight
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kq = k + q * (GRAD_ALPHA_THREADS / 32);
        const bool ok = kq < N && c <= kq;
        w[q] = ok ? __ldg(Wb + (size_t)kq * N + c) : 0.0f;
        x[q] = ok ? __ldg(ab + kq) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) s = fmaf(w[q], x[q], s);
    }
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < N) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < GRAD_ALPHA_THREADS / 32; ++w) t += red[w][lane];
    alpha[(size_t)b * N + c] = t;
    derr[(size_t)b * N + c] = g[b] * t;
  }
}

__global__ void __launch_bounds__(256, 3) stationary_nll_grad_kernel(
    const float* __restrict__ d2s,    // (JD, N, N)
    const float* __restrict__ W,      // (B, N, N), lower triangular
    const float* __restrict__ alpha,  // (B, N), from stationary_nll_grad_alpha
    const float* __restrict__ g,      // (B,)
    const float* __restrict__ mask,   // (B, N) or null for all ones
    const float* __restrict__ vs,     // (J, B)
    const float* __restrict__ ls,     // (JD, B), s = 1/l^2
    const float* __restrict__ als,    // (J, B) or null for all ones
    float* __restrict__ part,         // (B, U, NQ): the units' sums
    unsigned* __restrict__ tickets,   // (B,): zeros, left zero
    float* __restrict__ dv,           // (J, B)
    float* __restrict__ dl,           // (JD, B)
    float* __restrict__ dal,          // (J, B)
    float* __restrict__ dnoise,       // (B,)
    int B, int N, Atoms atoms, GradUnits units) {
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int U = units.U, G = units.G, wb = SP * G;
  const int b = blockIdx.x / U, u = blockIdx.x % U;
  int I = 0, Jg = 0;  // units.row[u], units.grp[u] by constant indices (no local copy)
#pragma unroll
  for (int x = 0; x < GRAD_MAX_UNITS; ++x)
    if (x == u) I = units.row[x], Jg = units.grp[x];
  const int J = atoms.J, prod = atoms.combine;
  int JD = 0;
#pragma unroll
  for (int q = 0; q < MAX_ATOMS; ++q) JD += q < J ? atoms.dims[q] : 0;
  const int NQ = 2 * J + JD + 1;  // dv (the product: one sum), ds, dalpha, dnoise
  const GradLayout ly = grad_layout(G, NQ, nt);
  float* ring = smem;
  float* vec = smem + ly.vec;  // alpha, m on rows 32 I + x; alpha, m on columns wb Jg + x
  float* sv = smem + ly.prm;   // s (MAX_MATS), v, alpha (MAX_ATOMS each), P = prod v
  float* vv = sv + MAX_MATS;
  float* av = vv + MAX_ATOMS;
  int* fams = reinterpret_cast<int*>(smem + ly.meta);  // families, d2 counts, offsets, flag
  int* dms = fams + MAX_ATOMS;
  int* offs = dms + MAX_ATOMS;
  float* red = smem + ly.red;

  // model b's parameters and the atoms (by constant indices), alpha and the
  // mask on the unit's rows and columns (zeros past N)
  {
    int off = 0;
#pragma unroll
    for (int q = 0; q < MAX_ATOMS; ++q) {
      if (tid == q) fams[q] = atoms.family[q], dms[q] = atoms.dims[q], offs[q] = off;
      off += q < J ? atoms.dims[q] : 0;
    }
  }
  if (tid < JD) {
    const float l = ls[(size_t)tid * B + b];
    sv[tid] = 1.0f / (l * l);
  }
  if (tid < J) {
    vv[tid] = vs[(size_t)tid * B + b];
    av[tid] = als ? als[(size_t)tid * B + b] : 1.0f;
  }
  if (tid == 0) {
    float P = 1.0f;
    for (int q = 0; q < J; ++q) P *= vs[(size_t)q * B + b];
    av[MAX_ATOMS] = P;
  }
  for (int x = tid; x < SP + wb; x += nt) {
    const int i = x < SP ? SP * I + x : wb * Jg + x - SP;
    float* dst = x < SP ? vec + x : vec + 2 * SP + (x - SP);
    const bool in = i < N;
    dst[0] = in ? alpha[(size_t)b * N + i] : 0.0f;
    dst[x < SP ? SP : wb] = in ? (mask ? mask[(size_t)b * N + i] : 1.0f) : 0.0f;
  }

  // K^{-1} on tiles (I, G Jg + t), t < G: warps 2 t and 2 t + 1, rows 16 h
  // + 4 tr .. + 3 of the tile and columns 4 tc .. + 3, for h = warp % 2,
  // (tr, tc) = (lane / 8, lane % 8).
  const int t = warp >> 1, r0 = 16 * (warp & 1) + 4 * (lane >> 3), c0 = SP * t + 4 * (lane & 7);
  const int Jt = G * Jg + t;
  const bool live = Jt <= I;
  const float* Wb = W + (size_t)b * N * N;
  const int k0 = SP * I, stages = (N - k0 + GRAD_BK - 1) / GRAD_BK;
  const int stage = GRAD_BK * (SP + wb);
  // A thread's copies of a stage: of the group's live columns (below
  // 32 (I + 1)), column tid % wb in rows tid / wb + 2 p; and, unless tile I
  // is in the group (a diagonal unit, which reads it there), of tile I's 32
  // columns, column tid % 32 in rows tid / 32 + 2 G p
  const bool diag = I < G * (Jg + 1);
  const int cA = k0 + (tid & 31), rA = tid >> 5, cB = wb * Jg + tid % wb, rB = tid / wb;
  const int lda = diag ? wb : SP, offA = diag ? GRAD_BK * SP + SP * (I - G * Jg) : 0;
  auto fill = [&](float* dst, int kb) {
    for (int r = rA; !diag && r < GRAD_BK; r += 2 * G) {
      const int k = kb + r;
      float* d = dst + r * SP + (tid & 31);
      if (k < N && cA <= k)
        cp_async_f32(d, Wb + (size_t)k * N + cA);
      else
        *d = 0.0f;
    }
    if (cB >= SP * (I + 1)) return;
    float* dB = dst + GRAD_BK * SP + cB - wb * Jg;
#pragma unroll 4
    for (int r = rB; r < GRAD_BK; r += 2) {
      const int k = kb + r;
      if (k < N && cB <= k)
        cp_async_f32(dB + r * wb, Wb + (size_t)k * N + cB);
      else
        dB[r * wb] = 0.0f;
    }
  };
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
#pragma unroll
  for (int p = 0; p < GRAD_STAGES - 1; ++p) {
    if (p < stages) fill(ring + p * stage, k0 + p * GRAD_BK);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    const int next = s + GRAD_STAGES - 1;
    if (next < stages) fill(ring + (next % GRAD_STAGES) * stage, k0 + next * GRAD_BK);
    cp_async_commit();  // (empty past the last stage)
    cp_async_wait<GRAD_STAGES - 1>();
    __syncthreads();
    if (live) {
      const float* As = ring + (s % GRAD_STAGES) * stage + offA;
      const float* Bs = ring + (s % GRAD_STAGES) * stage + GRAD_BK * SP;
#pragma unroll 8
      for (int kk = 0; kk < GRAD_BK; ++kk) {
        const float4 x = *reinterpret_cast<const float4*>(As + kk * lda + r0);
        const float4 y = *reinterpret_cast<const float4*>(Bs + kk * wb + c0);
        const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(xs[r], ys[e], acc[r][e]);
      }
    }
    __syncthreads();  // the stage is read before it is filled again
  }
  cp_async_wait<0>();

  // The epilogue on the thread's 4 x 4 block: T in acc's place, then each
  // atom's terms, the block's sum of each added to the thread's slot once
  float* sums = ring;
  for (int q = 0; q < NQ; ++q) sums[q * nt + tid] = 0.0f;
  if (live) {
    const size_t NN = (size_t)N * N;
    const float wgt = Jt == I ? 1.0f : 2.0f;
    const float* ca = vec + 2 * SP;
    const float* cm = ca + wb;
    const int i0 = SP * I + r0, j0 = wb * Jg + c0;
    unsigned okm = 0;  // bit 4 r + e: entry (i0 + r, j0 + e) lies inside the matrix
    float dn = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float ai = vec[r0 + r], mi = vec[SP + r0 + r];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = i0 + r < N && j0 + e < N;
        okm |= ok ? 1u << (4 * r + e) : 0u;
        if (ok && i0 + r == j0 + e) dn += mi * (acc[r][e] - ai * ai);
        acc[r][e] = wgt * (mi * cm[c0 + e]) * (acc[r][e] - ai * ca[c0 + e]);
      }
    }
    sums[(NQ - 1) * nt + tid] = dn;
    for (int q = 0; q < J; ++q) {
      float u[16], x[16];  // u_q, then x phi'_q; x = T prod_{k != q} phi_k (the sum: T)
      arg16(u, d2s, NN, i0, j0, N, okm, sv, offs[q], dms[q]);
#pragma unroll
      for (int t = 0; t < 16; ++t) x[t] = acc[t >> 2][t & 3];
      for (int k = 0; prod && k < J; ++k) {
        if (k == q) continue;
        float w[16];
        arg16(w, d2s, NN, i0, j0, N, okm, sv, offs[k], dms[k]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float wc[4] = {w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]}, pk[4], n0[4], n1[4];
          atom4<false>(fams[k], wc, av[k], pk, n0, n1);
#pragma unroll
          for (int e = 0; e < 4; ++e) x[4 * c + e] *= pk[e];
        }
      }
      float sp = 0.0f, sa = 0.0f;  // sum x phi, sum x dphi/dalpha
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float uc[4] = {u[4 * c], u[4 * c + 1], u[4 * c + 2], u[4 * c + 3]}, p[4], dp[4], da[4];
        atom4<true>(fams[q], uc, av[q], p, dp, da);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 4 * c + e;
          const bool ok = (okm >> t) & 1u;
          sp += ok ? x[t] * p[e] : 0.0f;
          sa += ok ? x[t] * da[e] : 0.0f;
          u[t] = ok ? x[t] * dp[e] : 0.0f;
        }
      }
      if (!prod || q == 0) sums[(prod ? 0 : q) * nt + tid] += sp;  // the product's one sum
      if (has_alpha(fams[q])) sums[(J + JD + q) * nt + tid] += sa;
      for (int d = 0; d < dms[q]; ++d) {
        float y[16];
        load16(y, d2s + (size_t)(offs[q] + d) * NN, i0, j0, N, okm);
        float sd = 0.0f;
#pragma unroll
        for (int t = 0; t < 16; ++t) sd += u[t] * y[t];
        sums[(J + offs[q] + d) * nt + tid] += sd;
      }
    }
  }

  // The unit's sums, added in warp order, to its slot; the model's last CTA
  // adds the slots in unit order and writes the gradients.
  const int nw = nt >> 5;
  for (int q = 0; q < NQ; ++q) {
    float v = sums[q * nt + tid];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (lane == 0) red[q * nw + warp] = v;
  }
  __syncthreads();
  float* slot = part + ((size_t)b * U + u) * NQ;
  for (int q = tid; q < NQ; q += nt) {
    float v = 0.0f;
    for (int w = 0; w < nw; ++w) v += red[q * nw + w];
    slot[q] = v;
  }
  int* flag = offs + MAX_ATOMS;
  __threadfence();  // the slot is visible before the ticket is
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(tickets + b, 1u) == (unsigned)(U - 1);
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  float* tot = red + NQ * nw;
  for (int q = tid; q < NQ; q += nt) {
    float v = 0.0f;
    for (int x = 0; x < U; ++x) v += __ldcg(part + ((size_t)b * U + x) * NQ + q);
    tot[q] = v;
  }
  __syncthreads();
  const float c = 0.5f * g[b];
  if (tid < J) {
    const int q = tid;
    const float P = av[MAX_ATOMS], vq = vv[q], scale = prod ? P : vq;
    dv[(size_t)q * B + b] = prod ? c * tot[0] * (P / vq) : c * tot[q];
    for (int d = 0; d < dms[q]; ++d) {
      const int k = offs[q] + d;
      const float l = ls[(size_t)k * B + b];
      dl[(size_t)k * B + b] = c * scale * tot[J + k] * (-2.0f / (l * l * l));
    }
    dal[(size_t)q * B + b] = has_alpha(fams[q]) ? c * scale * tot[J + JD + q] : 0.0f;
  }
  if (tid == 0) {
    dnoise[b] = c * tot[NQ - 1];
    tickets[b] = 0u;
  }
}

// The backward's units at N: G tile columns a unit (4 from T = 4 on, else
// 2 or 1), every (tile row I, group Jg with G Jg <= I), ordered by their
// work (tiles times rows streamed), heaviest first, ties in (I, Jg) order.
// They depend on N alone.
static GradUnits grad_units(int N) {
  const int T = (N + SP - 1) / SP;
  GradUnits un;
  un.G = T >= 4 ? 4 : (T >= 2 ? 2 : 1);
  un.U = 0;
  int work[GRAD_MAX_UNITS];
  for (int I = 0; I < T; ++I) {
    for (int Jg = 0; un.G * Jg <= I; ++Jg) {
      const int tiles = I + 1 - un.G * Jg < un.G ? I + 1 - un.G * Jg : un.G;
      const int w = tiles * (N - SP * I);
      int x = un.U++;
      for (; x > 0 && work[x - 1] < w; --x) {
        work[x] = work[x - 1];
        un.row[x] = un.row[x - 1];
        un.grp[x] = un.grp[x - 1];
      }
      work[x] = w;
      un.row[x] = (unsigned char)I;
      un.grp[x] = (unsigned char)Jg;
    }
  }
  return un;
}

static cudaError_t launch_grad(const float* d2s, const float* W, const float* a, const float* g,
                               const float* mask, const float* vs, const float* ls,
                               const float* als, float* alpha, float* part, unsigned* tickets,
                               float* dv, float* dl, float* dal, float* dnoise, float* derr,
                               int B, int N, const Atoms& atoms, int JD, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;  // dynamic shared bytes the kernel may ask for
  const GradUnits un = grad_units(N);
  const int nt = 2 * SP * un.G, NQ = 2 * atoms.J + JD + 1, T = (N + SP - 1) / SP;
  const size_t bytes = (size_t)grad_layout(un.G, NQ, nt).total * sizeof(float);
  if (bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(stationary_nll_grad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    allowed = bytes;
  }
  stationary_nll_grad_alpha<<<B * T, GRAD_ALPHA_THREADS, 0, stream>>>(W, a, g, alpha, derr, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  stationary_nll_grad_kernel<<<B * un.U, nt, bytes, stream>>>(
      d2s, W, alpha, g, mask, vs, ls, als, part, tickets, dv, dl, dal, dnoise, B, N, atoms, un);
  return cudaGetLastError();
}

static long long g_launches[3];  // the tile kernel's, the cluster kernel's, the backward's

// Plain C entry point: every pointer is a device pointer except `families`
// and `dims` (host arrays of J ints). N <= 256 runs the tile kernel,
// 256 < N <= 512 the cluster kernel; larger N is refused
// (cudaErrorInvalidValue). Returns the cudaError_t of the launch.
extern "C" int stationary_nll_launch(const float* d2s, const float* err,
                                     const float* mask, const float* vs,
                                     const float* ss, const float* als,
                                     const float* noise, float* nll, float* a_out,
                                     float* W, int B, int N, int J,
                                     const int* families, const int* dims,
                                     int combine, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (N > MAX_N || J < 1 || J > MAX_ATOMS) return (int)cudaErrorInvalidValue;
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
    e = W ? launch_cluster<true>(d2s, err, mask, vs, ss, als, noise, nll, a_out, W, B, N, atoms,
                                 s)
          : launch_cluster<false>(d2s, err, mask, vs, ss, als, noise, nll, a_out, W, B, N, atoms,
                                  s);
  if (e == cudaSuccess) ++g_launches[tiled ? 0 : 1];
  return (int)e;
}

// The backward: dv (J, B), dl (JD, B), dal (J, B), dnoise (B,) and derr
// (B, N) for the cotangent g (B,) from the forward's W (B, N, N) and a
// (B, N), on the operands of stationary_nll_launch with ls = l (not s)
// and als null for all ones. Scratch: alpha (B, N), part (B, U, NQ) with
// U = stationary_nll_grad_units(N) and NQ = 2 J + sum(dims) + 1, tickets
// (B,) zeros, left zero. Two launches on `stream`; counted once.
extern "C" int stationary_nll_grad_launch(const float* d2s, const float* W, const float* a,
                                          const float* g, const float* mask, const float* vs,
                                          const float* ls, const float* als, float* alpha,
                                          float* part, unsigned* tickets, float* dv, float* dl,
                                          float* dal, float* dnoise, float* derr, int B, int N,
                                          int J, const int* families, const int* dims,
                                          int combine, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (N > MAX_N || J < 1 || J > MAX_ATOMS) return (int)cudaErrorInvalidValue;
  Atoms atoms;
  atoms.J = J;
  atoms.combine = combine;
  int jd = 0;
  for (int q = 0; q < MAX_ATOMS; ++q) {
    atoms.family[q] = q < J ? families[q] : 0;
    atoms.dims[q] = q < J ? dims[q] : 0;
    if (q < J && dims[q] < 1) return (int)cudaErrorInvalidValue;
    jd += atoms.dims[q];
  }
  if (jd > MAX_MATS) return (int)cudaErrorInvalidValue;
  const cudaError_t e = launch_grad(d2s, W, a, g, mask, vs, ls, als, alpha, part, tickets, dv, dl,
                                    dal, dnoise, derr, B, N, atoms, jd, (cudaStream_t)stream);
  if (e == cudaSuccess) ++g_launches[2];
  return (int)e;
}

// The backward's units a model at N (its workspace's U), or -1 outside the
// window.
extern "C" int stationary_nll_grad_units(int N) {
  return N <= 0 || N > MAX_N ? -1 : grad_units(N).U;
}

// Launches since the library was loaded: out[0] of the tile kernel, out[1]
// of the cluster kernel, out[2] of the backward (its two kernels once).
extern "C" void stationary_nll_kernel_launches(long long* out) {
  out[0] = g_launches[0];
  out[1] = g_launches[1];
  out[2] = g_launches[2];
}

// CTAs of the kernel that runs at this N resident on one SM at once
// (occupancy), or -1 on error.
extern "C" int stationary_nll_ctas_per_sm(int N, int with_w) {
  if (N <= 0 || N > MAX_N) return -1;
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
    const ClusterShape sh = cluster_shape(N);
    if (sh.C < 0) return -1;
    const size_t bytes = sh.bytes;
    e = with_w ? configure_cluster<true>() : configure_cluster<false>();
    if (e != cudaSuccess) return -1;
    e = with_w ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, stationary_nll_cluster_kernel<true>, TILE_THREADS, bytes)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, stationary_nll_cluster_kernel<false>, TILE_THREADS, bytes);
  }
  return e == cudaSuccess ? n : -1;
}

// The cluster kernel's shape at 256 < N <= 512: out[0] the cluster size C,
// out[1] the warps a tile column of W (G), out[2] the shared bytes a CTA,
// out[3] the clusters of that shape resident on the device at once
// (cudaOccupancyMaxActiveClusters, for the variant with W). Returns
// cudaErrorInvalidValue outside the window, else the query's error.
extern "C" int stationary_nll_cluster_shape(int N, int* out) {
  if (N <= MAX_TILE_N || N > MAX_N) return (int)cudaErrorInvalidValue;
  const ClusterShape sh = cluster_shape(N);
  if (sh.C < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = configure_cluster<true>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_launch(1, sh, attr, 0);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)stationary_nll_cluster_kernel<true>, &cfg);
  out[0] = sh.C;
  out[1] = sh.G;
  out[2] = (int)sh.bytes;
  out[3] = n;
  return (int)e;
}
