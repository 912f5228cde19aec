// Shared by the port's CUDA sources (lakesoul_tpu_torch/csrc/*.cu).  Each
// source is its own shared library and includes this header once, so each
// library exports its own ls_cuda_error_string for its ctypes wrapper.
// lakesoul_tpu_torch/_build.py hashes this header into every library's name,
// so an edit here rebuilds them all.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Sum of v over the 32 lanes of a warp; every lane gets the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async from device to shared memory, zero-filled past src_bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4- or 8-byte copy of one element, zero-filled when src_bytes is 0
template <int B>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(B), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed cp.async groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Blocks for a grid-stride loop over `work` units of `per_block` each: enough
// to fill every SM `waves` times, never more than the work needs.
inline unsigned grid_for(int64_t work, int per_block, int waves = 16) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t need = (work + per_block - 1) / per_block;
  const int64_t cap = static_cast<int64_t>(sms) * waves;
  return static_cast<unsigned>(need < cap ? need : cap);
}

// Raise the dynamic shared-memory limit of `kernel` when `bytes` passes the
// 48 KB default.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

extern "C" const char* ls_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
