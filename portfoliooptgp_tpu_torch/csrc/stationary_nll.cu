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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "chol_tile.cuh"
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

static long long g_launches[2];  // the tile kernel's, the cluster kernel's

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

// Launches since the library was loaded: out[0] of the tile kernel, out[1]
// of the cluster kernel.
extern "C" void stationary_nll_kernel_launches(long long* out) {
  out[0] = g_launches[0];
  out[1] = g_launches[1];
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
