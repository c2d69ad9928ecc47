// Inverse of the 128 x 128 diagonal blocks of lower-triangular factors, for
// Hopper.
//
// Replaces the TPU kernel portfoliooptgp_tpu/ops/pallas/nll.py:_trinv_kernel
// (called through triangular_inverse_pallas by blocked_nll.py:
// blocked_triangular_inverse, the first stage of the `blocked_hinv` NLL tier
// for 1024 < padded N <= 4096). The joins that assemble the whole inverse
// from these blocks stay full-fp32 torch.matmul (ops/blocked_nll.py).
//
// Input: B lower-triangular factors, each Np x Np with Np = 128 P, read in
// place through their batch, row and column strides. Output: the
// inverse W = L^{-1} of each of the B P diagonal blocks, written contiguously
// as (B, P, 128, 128) with exact zeros above the diagonal. Only the lower
// triangle of each block is read. Nothing is clamped: a zero pivot gives inf,
// a NaN in L gives NaN in every entry of W that depends on it and nowhere
// else, so a failed factor reaches the NLL as NaN and the L-BFGS line search
// rejects the step.
//
// Each entry is the forward-substitution formula of the plain version,
//   W[r][j] = (delta_rj - sum_{i = j}^{r-1} L[r][i] W[i][j]) / L[r][r],
// with its sum split by 32-row blocks: a product over the earlier blocks,
// then the diagonal block's own rows in registers, the division last. The
// terms are taken in the plain version's order (i increasing, each fused
// into one FMA) and the division rounds as IEEE division does (`divide`):
// the rounding of a column-at-a-time substitution. Every term of the triangular range is taken and no other
// (a masked term is skipped under a predicate, never multiplied by a zero),
// so which entries are NaN or infinite does not depend on the order of the
// sums: it is exactly the plain version's. (Inverting the 32 x 32
// diagonal blocks first and joining them by -W22 L21 W11 would divide
// before it sums, and turn the +-inf that a zero pivot gives into NaN.)
//
// Design. One CTA per block, a thread per column j of W. Thread j computes
// column j row block by row block (R = j/32 .. 3): x = delta - (L W) over the
// earlier row blocks, 32 accumulators in registers, then the forward solve
// against the diagonal 32-block in registers. W's column j is read back only
// by thread j, and L is read-only, so after the staging barrier no thread
// waits for another. The warp of columns 0..31 does the most (all four row
// blocks, 192-deep products); the others start later and finish sooner.
//
// Card features.
// - Shared memory: one 128 x 132 float array holds L transposed strictly
//   above its diagonal (M[i][r] = L[r][i], r > i) and W on and below it
//   (M[r][j] = W[r][j], j <= r), so the two never collide and W needs no
//   second array; the diagonal of L and its reciprocals are kept apart (2 x
//   128 floats). 68,608 bytes
//   a CTA, three CTAs an SM: the 220 blocks of a five-year grid NLL run in
//   one wave on 132 SMs (two 64 KB arrays would leave one CTA an SM, two
//   waves). The products read L as warp-wide broadcast float4 runs
//   M[i][32R .. 32R + 31]; W's reads and writes are a word per lane of
//   consecutive columns; the stride 132 = 4 mod 32 makes the transposing
//   stage conflict-free (a warp moves 4 rows x 8 columns at a time).
// - Asynchronous copies: the strict lower triangle is staged by 4-byte
//   cp.async (the strides of the views the caller passes may be odd). The
//   factors on the path come from torch.linalg.cholesky, column-major: a warp
//   copies 32 consecutive rows of one column into 32 consecutive words of
//   M, and no row-major copy of the factor is made first (158 MB at
//   20 x 1408, more time than the kernel).
// - Tensor cores: not used. The arithmetic is ~0.7 MFLOP per block (2.3 us
//   of fp32 work for 220 blocks), the port keeps fp32 at full precision, and
//   an MMA tile would multiply the structural zeros of a triangle, which
//   breaks the exact NaN pattern above.
//
// Bound on an H100 (SXM, 700 W) for the B P blocks: 2 * 4 * 128 * 129 / 2
// bytes per block (the lower triangle read once, the same entries of W written
// once) over 3.35 TB/s, against 128^3 / 3 fp32 operations per block over
// 67 TFLOP/s: bytes-bound, 4.3 us for the 220 blocks of a 20 x 1408 batch.
// The kernel's time is the column-0 warp's chain: ~8,000 register FMAs and
// ~1,600 shared loads.

#include <cuda_runtime.h>
#include <stddef.h>

#include "hopper_async.cuh"

#define PW 128             // block width, as the TPU kernel's
#define SB 32              // row block of the products and of the register solve
#define LDM (PW + 4)       // 132 = 4 mod 32
#define CTAS_PER_SM 3

// x -= L[r0 + rr][i] W[i][j] for the rows i of [i_begin, i_end): 32
// accumulators, a broadcast float4 run of L and one word of W per row i. With
// Masked, only the terms with i >= j are taken (W[i][j] = 0 above the
// diagonal), by a select: a masked term is never added, even as NaN * 0.
template <bool Masked>
__device__ __forceinline__ void product(float (&x)[SB], const float* M, int r0, int j,
                                        int i_begin, int i_end) {
#pragma unroll 4
  for (int i = i_begin; i < i_end; ++i) {
    const float w = M[i * LDM + j];
    const float4* l4 = reinterpret_cast<const float4*>(M + i * LDM + r0);  // L[r0 + rr][i]
    const bool take = !Masked || i >= j;
#pragma unroll
    for (int q = 0; q < SB / 4; ++q) {
      const float4 v = l4[q];
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float t = fmaf(-vs[u], w, x[4 * q + u]);
        x[4 * q + u] = take ? t : x[4 * q + u];
      }
    }
  }
}

// x / d rounded as IEEE division rounds it, from y = 1 / d correctly
// rounded (computed once per row, off the chain): q = x y, then the residual
// x - q d (exact in an FMA) corrects q to the correctly rounded quotient
// (Markstein), barring overflow or a subnormal quotient. Where q or the
// residual is not finite (d zero or infinite, x infinite or NaN) q is the
// quotient already, with IEEE division's inf and NaN.
__device__ __forceinline__ float divide(float x, float d, float y) {
  const float q = x * y;
  const float e = fmaf(-q, d, x);
  return isfinite(e) ? fmaf(e, y, q) : q;
}

// Forward solve of the row block [r0, r0 + 32) against its diagonal block:
// x[rr] /= L[r][r], then x[k] -= L[r0 + k][r] x[rr] for k > rr. With
// Masked, only the rows r >= j are taken.
template <bool Masked>
__device__ __forceinline__ void solve(float (&x)[SB], const float* M, const float* dg,
                                      const float* dy, int r0, int j) {
  float d[SB];
#pragma unroll
  for (int q = 0; q < SB / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(dg + r0)[q];
    d[4 * q] = v.x, d[4 * q + 1] = v.y, d[4 * q + 2] = v.z, d[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int rr = 0; rr < SB; ++rr) {
    const bool take = !Masked || r0 + rr >= j;
    const float xr = divide(x[rr], d[rr], dy[r0 + rr]);
    x[rr] = take ? xr : x[rr];
    const float* Lr = M + (r0 + rr) * LDM + r0;  // Lr[k] = L[r0 + k][r0 + rr] for k > rr
#pragma unroll
    for (int q = rr >> 2; q < SB / 4; ++q) {
      float vs[4];
      if (4 * q > rr) {  // a whole float4 below row rr
        const float4 v = *reinterpret_cast<const float4*>(Lr + 4 * q);
        vs[0] = v.x, vs[1] = v.y, vs[2] = v.z, vs[3] = v.w;
      } else {  // the float4 holding row rr: only its entries below it are read
#pragma unroll
        for (int u = 0; u < 4; ++u) vs[u] = 4 * q + u > rr ? Lr[4 * q + u] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (4 * q + u > rr) {
          const float t = fmaf(-vs[u], xr, x[4 * q + u]);
          x[4 * q + u] = take ? t : x[4 * q + u];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(PW, CTAS_PER_SM) trinv_kernel(
    const float* __restrict__ L,  // (B, Np, Np) with strides (sb, sr, sc)
    long long sb, long long sr, long long sc,
    float* __restrict__ W,        // (B, P, PW, PW), contiguous
    int P) {
  extern __shared__ __align__(16) float smem[];
  float* M = smem;              // PW x LDM: L^T strictly above the diagonal, W on and below
  float* dg = smem + PW * LDM;  // PW: L[r][r]
  float* dy = dg + PW;          // PW: 1 / L[r][r], correctly rounded
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const int blk = blockIdx.x;
  const int b = blk / P, p = blk - b * P;
  const float* Lb = L + (size_t)b * sb + (size_t)p * PW * (sr + sc);

  // Stage the strict lower triangle transposed. A column-major factor (what
  // torch.linalg.cholesky returns) is read a column per warp, 32 consecutive
  // rows at a time, into consecutive words of M; any other layout a row per
  // warp, 32 columns at a time.
  if (sr == 1) {
    for (int c = warp; c < PW; c += PW / 32)
      for (int r = c + 1 + lane; r < PW; r += 32)
        cp_async_f32(M + c * LDM + r, Lb + (size_t)c * sc + r);
  } else {
    for (int r = warp; r < PW; r += PW / 32)
      for (int c = lane; c < r; c += 32)
        cp_async_f32(M + c * LDM + r, Lb + (size_t)r * sr + (size_t)c * sc);
  }
  cp_async_commit();
  dg[j] = Lb[(size_t)j * (sr + sc)];
  dy[j] = __frcp_rn(dg[j]);
  cp_async_wait<0>();
  __syncthreads();

  float* Wb = W + (size_t)blk * PW * PW;
  const int J = warp;  // the row block of column j's diagonal entry
  for (int r = 0; r < SB * J; ++r) Wb[(size_t)r * PW + j] = 0.0f;

#pragma unroll 1
  for (int R = J; R < PW / SB; ++R) {
    const int r0 = SB * R;
    float x[SB];
#pragma unroll
    for (int rr = 0; rr < SB; ++rr) x[rr] = r0 + rr == j ? 1.0f : 0.0f;
    if (R == J) {
      solve<true>(x, M, dg, dy, r0, j);
    } else {
      product<true>(x, M, r0, j, SB * J, SB * J + SB);  // the diagonal block's rows
      product<false>(x, M, r0, j, SB * J + SB, r0);
      solve<false>(x, M, dg, dy, r0, j);
    }
    // Column j of the row block: into M for the later blocks, and out.
#pragma unroll
    for (int rr = 0; rr < SB; ++rr) {
      if (r0 + rr >= j) M[(r0 + rr) * LDM + j] = x[rr];
      Wb[(size_t)(r0 + rr) * PW + j] = x[rr];  // exactly 0 above the diagonal
    }
  }
}

static size_t smem_bytes() { return (size_t)(PW * LDM + 2 * PW) * sizeof(float); }

static cudaError_t configure() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(trinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes());
  if (e == cudaSuccess) configured = true;
  return e;
}

// Plain C entry point. `L` and `W` are device pointers; sb, sr and sc are L's
// batch, row and column strides in elements (any layout; column-major is read
// fastest). Inverts the P diagonal blocks of each of the B factors. Returns
// the cudaError_t of the launch.
extern "C" int trinv_launch(const float* L, long long sb, long long sr, long long sc,
                            float* W, int B, int P, void* stream) {
  if (B <= 0 || P <= 0) return (int)cudaSuccess;
  if ((long long)B * P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  trinv_kernel<<<B * P, PW, smem_bytes(), (cudaStream_t)stream>>>(L, sb, sr, sc, W, P);
  return (int)cudaGetLastError();
}

// CTAs of the kernel resident on one SM at once (occupancy), or -1 on error.
extern "C" int trinv_ctas_per_sm(void) {
  int n = -1;
  if (configure() != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, trinv_kernel, PW, smem_bytes()) !=
      cudaSuccess)
    return -1;
  return n;
}
