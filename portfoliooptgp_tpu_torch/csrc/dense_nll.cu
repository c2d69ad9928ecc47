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
// jitter, so the line search rejects the step as on the TPU. Nothing is
// padded: the TPU kernel pads N to 128 with an identity tail and zero
// targets (log 1 = 0 and 0^2 add nothing) and B to 8; here any N up to 256
// and any B are taken, and the 2 pi constant is the real N's.
//
// Design. The column loop of stationary_nll.cu with the build replaced by a
// read: the packed lower triangle of K_b + s_b I is staged into dynamic
// shared memory (N(N+1)/2 floats, 131,584 B at N = 256, inside the 232,448 B
// a block may use, so the launch raises the kernel's dynamic shared-memory
// limit), then a right-looking Cholesky walks the columns with the forward
// solve, the log-det and, with the flag, the row operations that turn I into
// L^{-1} in the same loop (the TPU's nll._blocked_chol fuses them the same
// way). W is an output and lives in global memory; L never leaves shared
// memory (the TPU kernel keeps it in VMEM scratch).
//
// Bound on an H100 (SXM, 700 W): per model N^3/3 flops of factor (+ N^3/3 of
// inverse) in N dependent column steps. At B = 128, N = 256 with W: 1.4 GFLOP
// of fp32 (~21 us at 67 TFLOP/s) against ~34 MB of W written and 17 MB of K
// read (~15 us at 3.35 TB/s): operations bound. At the multi-input shapes
// (B = 1..20, N = 72..77) a handful of CTAs occupy a handful of the 132 SMs
// and the time is the latency of N column steps of three barriers each. This
// first version does nothing about either beyond keeping L on chip and running
// 1024 threads per CTA; tensor-core trailing updates, TMA staging and a cluster
// per model are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define THREADS 1024
#define MAX_N 256  // the routing window's padded N (nll.MAX_PALLAS_N)

__device__ __forceinline__ size_t tri(int i) { return (size_t)i * (i + 1) / 2; }

template <bool WITH_W>
__global__ void __launch_bounds__(THREADS) dense_nll_kernel(
    const float* __restrict__ K,      // (B, N, N), strides (sb, sr, sc)
    long long sb, long long sr, long long sc,
    const float* __restrict__ y,      // (B, N), contiguous
    const float* __restrict__ noise,  // (B,)
    float* __restrict__ nll,          // (B,)
    float* __restrict__ logdet_out,   // (B,)
    float* __restrict__ a_out,        // (B, N)
    float* __restrict__ W,            // (B, N, N) when WITH_W
    int N) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t NN = (size_t)N * N;

  float* a = smem;       // N: y, then L^{-1} y
  float* col = a + N;    // N: column k of L
  float* red = col + N;  // 32: block reduction
  float* L = red + 32;   // N(N+1)/2: packed lower triangle
  float* Wb = WITH_W ? W + (size_t)b * NN : nullptr;
  const float* Kb = K + (size_t)b * sb;

  // 1. Stage the packed lower triangle of K_b + s_b I.
  const float nz = noise[b];
  for (size_t t = tid; t < NN; t += blockDim.x) {
    const int i = (int)(t / N);
    const int j = (int)(t - (size_t)i * N);
    if (j > i) continue;
    float k = Kb[(size_t)i * sr + (size_t)j * sc];
    if (i == j) k += nz;
    L[tri(i) + j] = k;
  }
  for (int i = tid; i < N; i += blockDim.x) a[i] = y[(size_t)b * N + i];
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

  // 3. Outputs: a, log-det, and nll = 1/2 |a|^2 + logdet + 1/2 N log 2 pi.
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
    logdet_out[b] = logdet;
    nll[b] = 0.5f * total + logdet + (float)(0.5 * N * 1.8378770664093453);
  }
}

static size_t smem_bytes(int N) {
  return ((size_t)2 * N + 32 + (size_t)N * (N + 1) / 2) * sizeof(float);
}

template <bool WITH_W>
static cudaError_t launch(const float* K, long long sb, long long sr, long long sc,
                          const float* y, const float* noise, float* nll, float* logdet,
                          float* a, float* W, int B, int N, cudaStream_t stream) {
  const size_t bytes = smem_bytes(N);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(dense_nll_kernel<WITH_W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
  }
  dense_nll_kernel<WITH_W><<<B, THREADS, bytes, stream>>>(K, sb, sr, sc, y, noise, nll,
                                                          logdet, a, W, N);
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
