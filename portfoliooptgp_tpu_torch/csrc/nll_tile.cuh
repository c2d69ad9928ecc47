// The tile core of the batched NLL kernels of csrc/dense_nll.cu and
// csrc/stationary_nll.cu: the lower triangle of an N x N matrix (N <= 256)
// as 32 x 32 tiles of 36-float rows in shared memory, factored in 32-column
// sub-panels by (a) a warp factor of the diagonal tile (factor_step), (b) a
// thread per row below solving that row against its transpose (solve) and
// (c) rank-32 updates of the trailing tiles on register micro-tiles
// (update_half); then, for the gradient, W = L^{-1} a column per thread by
// 32-row blocks (product, solve; form_inverse). dense_nll.cu's note gives
// the design and its reasons. A kernel that includes this header runs 256
// threads a CTA: form_inverse gives warp w the columns of tile column w.
// ops/cuda_build.library_path hashes this header with every source that
// includes it.

#pragma once

#include <stddef.h>

#include "chol_tile.cuh"

#define LDT (SP + 4)         // row stride of a tile: 36 floats, 9 float4s
#define TILE (SP * LDT)      // floats a tile

// Tile (R, S), R >= S, of the packed lower triangle of tiles.
__device__ __forceinline__ int tile_index(int R, int S) { return R * (R + 1) / 2 + S; }

// Forward substitution of one 32-row block against a factored diagonal
// tile, in place on x: for j = 0 .. 31, x[j] /= L(j, j), then x[m] -= L(m, j)
// x[j] for m > j: the column loop's own operations in its own order (for a
// row of L below the tile, x[m] -= L(m, j) L(i, j) is its trailing update).
// Lt is the tile transposed (row j = column j of L, read as broadcast float4
// runs), dg and yd its diagonal and the estimates of 1 / diag. Only the
// rows j >= r0 are taken, by predicates: the rows above (W's structural
// zeros in column c's own row block, r0 = c % 32) stay as they are and
// update nothing; r0 = 0 takes every row.
__device__ __forceinline__ void solve(float (&x)[SP], const float* Lt, const float* dg,
                                      const float* yd, int r0) {
#pragma unroll
  for (int j = 0; j < SP; ++j) {
    const bool take = j >= r0;
    const float xj = div_from(x[j], dg[j], yd[j]);
    x[j] = take ? xj : x[j];
#pragma unroll
    for (int q = j / 4; q < SP / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(Lt + j * SP)[q];
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (4 * q + u > j) {
          const float t = fmaf(-vs[u], xj, x[4 * q + u]);
          x[4 * q + u] = take ? t : x[4 * q + u];
        }
      }
    }
  }
}

// (c) A -= LR LS^T on one half (16 columns) of the tile A, LR and LS the
// sub-panel's tiles in A's tile row and tile column. Lane (g, h) = (lane % 8,
// lane / 8) takes rows g + 8 p (p < 4) and columns 16 half + 4 h + q
// (q < 4): per 4 k, 4 float4 of its rows and 4 of its columns for 64 FMAs.
// Above a diagonal tile's diagonal the update leaves junk that no real entry
// reads.
__device__ __forceinline__ void update_half(float* A, const float* LR, const float* LS,
                                            int half) {
  const int lane = threadIdx.x & 31, g = lane & 7, c0 = 16 * half + 4 * (lane >> 3);
  float acc[4][4] = {};
#pragma unroll 2
  for (int k = 0; k < SP; k += 4) {
    float4 u[4], v[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) u[p] = *reinterpret_cast<const float4*>(LR + (g + 8 * p) * LDT + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = *reinterpret_cast<const float4*>(LS + (c0 + q) * LDT + k);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[p][q] = fmaf(u[p].x, v[q].x, acc[p][q]);
        acc[p][q] = fmaf(u[p].y, v[q].y, acc[p][q]);
        acc[p][q] = fmaf(u[p].z, v[q].z, acc[p][q]);
        acc[p][q] = fmaf(u[p].w, v[q].w, acc[p][q]);
      }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float4* dst = reinterpret_cast<float4*>(A + (g + 8 * p) * LDT + c0);
    float4 w = *dst;
    w.x -= acc[p][0];
    w.y -= acc[p][1];
    w.z -= acc[p][2];
    w.w -= acc[p][3];
    *dst = w;
  }
}

// The inverse's product with an earlier row block S of column c:
// x[rr] -= sum_m L(32 J + rr, 32 S + m) W(32 S + m, c), m increasing. Wt is
// column c's entries of W's tile (S, c / 32) (row stride LDT), Lt the tile
// (J, S) of L, read as broadcast float4 runs. Only the terms m >= m0 are
// taken, by predicates: in column c's own tile (S = c / 32) m0 = c % 32 skips
// W's structural zeros above the diagonal; elsewhere m0 = 0.
__device__ __forceinline__ void product(float (&x)[SP], const float* Wt, const float* Lt,
                                        int m0) {
  float w[SP];
#pragma unroll
  for (int m = 0; m < SP; ++m) w[m] = Wt[m * LDT];
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

static size_t smem_floats(int N, bool with_w) {
  const int T = (N + SP - 1) / SP, Np = SP * T;
  return (size_t)T * (T + 1) / 2 * TILE + (size_t)(with_w ? T : 1) * SP * SP + 3 * (size_t)Np +
         SP * SP + 32;
}

// (a) for tile k: warp 0 factors the diagonal tile, keeps its diagonal, the
// estimates and its transpose Lt, and adds to the log sum.
__device__ __forceinline__ void factor_step(float* tiles, float* Lt, float* dg, float* yd,
                                            float* lt, int k, int N, float& ld) {
  const int lane = threadIdx.x & 31;
  float* D = tiles + tile_index(k, k) * TILE;
  ld += factor_diagonal<LDT>(D, dg + SP * k, yd + SP * k, lt, N - SP * k);
  float x[SP];
  load_row(x, D + lane * LDT);
#pragma unroll
  for (int c = 0; c < SP; ++c) Lt[c * SP + lane] = x[c];
}

// W = L^{-1}, once the factor is done: thread c owns column c; row block J
// of W replaces row block J of L in the tiles once every thread has read
// it, and goes out to Wb (N x N, row-major) in coalesced rows, once. Lt(J)
// is the transpose of diagonal tile J, dg and yd the diagonal of L and the
// estimates of 1 / diag. Every thread of the CTA calls it (two barriers a
// row block).
template <class LtOf>
__device__ __forceinline__ void form_inverse(float* tiles, LtOf Lt, const float* dg,
                                             const float* yd, float* Wb, int N, int T) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Jc = warp, c = tid, cl = lane;
  for (int J = 0; J < T; ++J) {
    const bool active = c < N && J >= Jc;
    float x[SP];
#pragma unroll
    for (int rr = 0; rr < SP; ++rr) x[rr] = active && SP * J + rr == c ? 1.0f : 0.0f;
    if (active) {  // one call site each: specialised copies ran slower
      const float* Wc = tiles + cl;  // column c of W's tiles (S, Jc)
      for (int S = Jc; S < J; ++S)
        product(x, Wc + tile_index(S, Jc) * TILE, tiles + tile_index(J, S) * TILE,
                S == Jc ? cl : 0);
      solve(x, Lt(J), dg + SP * J, yd + SP * J, J == Jc ? cl : 0);
    }
    __syncthreads();  // every read of L's row block J is done
    if (active) {
      float* Wt = tiles + tile_index(J, Jc) * TILE + cl;
#pragma unroll
      for (int rr = 0; rr < SP; ++rr) Wt[rr * LDT] = x[rr];
    }
    if (c < N) {
#pragma unroll
      for (int rr = 0; rr < SP; ++rr)
        if (SP * J + rr < N) Wb[(size_t)(SP * J + rr) * N + c] = x[rr];  // 0 above the diagonal
    }
    __syncthreads();  // row block J of W is in the tiles
  }
}
