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
// place through their batch and row strides (column stride 1). Output: the
// inverse W = L^{-1} of each of the B P diagonal blocks, written contiguously
// as (B, P, 128, 128) with exact zeros above the diagonal. Only the lower
// triangle of each block is read. Forward substitution against the identity,
// as the TPU kernel does it (W <- I; for each row i: W[i, :] /= L[i, i];
// W[r, :] -= L[r, i] W[i, :] for r > i), restricted to the columns j <= i where
// W[i, j] can be nonzero. Nothing is clamped: a zero pivot gives inf, a NaN in
// L gives NaN in every entry of W that depends on it, so a failed factor
// reaches the NLL as NaN and the L-BFGS line search rejects the step.
//
// Design. One CTA per block and one thread per column j of W. The block's lower
// triangle and W are staged in shared memory (2 x 64 KB, above the 48 KB
// default, so the launch raises the kernel's dynamic shared-memory limit).
// Thread j updates only column j, so after the staging barrier the 128 row
// steps need no barrier. At step i the active threads (j <= i) read the same
// L[r][i] (a broadcast) and their own W[r][j] (consecutive words, no bank
// conflict).
//
// Bound on an H100 (SXM, 700 W) for the B P blocks: 2 * 4 * 128 * 129 / 2
// bytes per block (the lower triangle read once, the same entries of W written
// once) over 3.35 TB/s, against 128^3 / 3 fp32 operations per block over
// 67 TFLOP/s: bytes-bound, 4.3 us for the 220 blocks of a 20 x 1408 batch.
// This kernel is latency-bound instead: the thread of column 0 runs ~128^2 / 2
// dependent shared-memory updates, and the 128 KB of shared memory leave one
// CTA (four warps) per SM. Inverting the block by 32 x 32 sub-blocks with
// tensor-core products, and several blocks per CTA, are later work.

#include <cuda_runtime.h>
#include <stddef.h>

#define PW 128  // block width, as the TPU kernel's

__global__ void __launch_bounds__(PW) trinv_kernel(
    const float* __restrict__ L,  // (B, Np, Np) with strides (sb, sr, 1)
    long long sb, long long sr,
    float* __restrict__ W,        // (B, P, PW, PW), contiguous
    int P) {
  extern __shared__ float smem[];
  float* Ls = smem;            // PW x PW: the block's lower triangle, zeros above
  float* Ws = smem + PW * PW;  // PW x PW: column j belongs to thread j
  const int j = threadIdx.x;
  const int blk = blockIdx.x;
  const int b = blk / P, p = blk - b * P;
  const float* Lb = L + (size_t)b * sb + (size_t)p * PW * sr + (size_t)p * PW;

  for (int r = 0; r < PW; ++r) {
    Ls[r * PW + j] = j <= r ? Lb[(size_t)r * sr + j] : 0.0f;
    Ws[r * PW + j] = r == j ? 1.0f : 0.0f;
  }
  __syncthreads();

  for (int i = 0; i < PW; ++i) {
    if (j > i) continue;  // W[i][j] = 0 above the diagonal: nothing to subtract
    const float w = Ws[i * PW + j] / Ls[i * PW + i];
    Ws[i * PW + j] = w;
#pragma unroll 4
    for (int r = i + 1; r < PW; ++r) Ws[r * PW + j] -= Ls[r * PW + i] * w;
  }

  float* Wb = W + (size_t)blk * PW * PW;
  for (int r = 0; r < PW; ++r) Wb[(size_t)r * PW + j] = Ws[r * PW + j];
}

static size_t smem_bytes() { return (size_t)2 * PW * PW * sizeof(float); }

// Plain C entry point. `L` and `W` are device pointers; sb and sr are L's batch
// and row strides in elements. Inverts the P diagonal blocks of each of the B
// factors. Returns the cudaError_t of the launch.
extern "C" int trinv_launch(const float* L, long long sb, long long sr, float* W, int B,
                            int P, void* stream) {
  if (B <= 0 || P <= 0) return (int)cudaSuccess;
  if ((long long)B * P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(trinv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  trinv_kernel<<<B * P, PW, smem_bytes(), (cudaStream_t)stream>>>(L, sb, sr, W, P);
  return (int)cudaGetLastError();
}
