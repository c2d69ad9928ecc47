// Asynchronous global -> shared copies (cp.async, sm_80 and later) shared by
// the kernels of csrc/blocked_panel.cu, csrc/trinv.cu, csrc/dense_nll.cu and
// the backward of csrc/stationary_nll.cu.
//
// The copies are 4 bytes wide on purpose: the kernels may transpose while they
// stage (a row of the input lands in a column of the shared tile), and their
// inputs are strided views whose row strides may be odd (875, 747, ... floats),
// so a 16-byte copy would need a run-time alignment check on every row and a
// second path for the rows that fail it. A 4-byte copy is always aligned.
// ops/cuda_build.library_path hashes this header with every source that
// includes it, so an edited header rebuilds them.

#pragma once

// Issue one 4-byte copy from global memory to shared memory; it lands in the
// current commit group.
__device__ __forceinline__ void cp_async_f32(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

// Close the current group of copies.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` of this thread's groups are still in flight.
// The copies of other threads are visible only after a __syncthreads().
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}
