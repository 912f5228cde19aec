// Exact squared-L2 scan for the brute-force oracle, for Hopper (sm_90a).
// Built by lakesoul_tpu_torch/_build.py into a shared library with a plain C
// interface and bound through ctypes (lakesoul_tpu_torch/vector/kernels.py).
//
// ls_bruteforce_distances replaces lakesoul_tpu/vector/kernels.py
//   bruteforce_distances_pallas -> _bruteforce_kernel.
//   x [N, D] f32, q [D] f32 -> out[n] = |x_n|^2 - 2 x_n . q + |q|^2, [N] f32.
//
// Bound: bytes.  It reads each row once (N x D x 4 bytes: 5.1 GB, ~1.5 ms at
// 3.35 TB/s, for the plane's 10,000,000 x 128 oracle) for 4 FLOP a value.
// Design: the query sits in shared memory and every block reduces |q|^2 from
// it; one warp takes one row at a time (grid-stride), its lanes along D with
// 16-byte loads when D % 4 == 0 and the base is aligned, 4-byte loads
// otherwise; one pass over the row gives both sum(x^2) and sum(x * q), two
// shuffle reduces, and lane 0 writes the row's distance.

#include "ls_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
bruteforce_kernel(const float* __restrict__ x, const float* __restrict__ q,
                  float* __restrict__ out, int64_t n, int dd) {
  extern __shared__ __align__(16) float q_sm[];  // dd floats
  __shared__ float red[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float sq = 0.f;
  for (int k = threadIdx.x; k < dd; k += kThreads) {
    const float v = q[k];
    q_sm[k] = v;
    sq = fmaf(v, v, sq);
  }
  sq = warp_sum(sq);
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  float q_sq = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) q_sq += red[w];

  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp; row < n;
       row += static_cast<int64_t>(gridDim.x) * kWarps) {
    const float* r = x + row * dd;
    float xs = 0.f, dot = 0.f;
    if constexpr (VEC) {
      for (int k = 4 * lane; k < dd; k += 128) {
        const float4 v = *reinterpret_cast<const float4*>(r + k);
        const float4 y = *reinterpret_cast<const float4*>(q_sm + k);
        xs = fmaf(v.x, v.x, xs);
        xs = fmaf(v.y, v.y, xs);
        xs = fmaf(v.z, v.z, xs);
        xs = fmaf(v.w, v.w, xs);
        dot = fmaf(v.x, y.x, dot);
        dot = fmaf(v.y, y.y, dot);
        dot = fmaf(v.z, y.z, dot);
        dot = fmaf(v.w, y.w, dot);
      }
    } else {
      for (int k = lane; k < dd; k += 32) {
        const float v = r[k];
        xs = fmaf(v, v, xs);
        dot = fmaf(v, q_sm[k], dot);
      }
    }
    xs = warp_sum(xs);
    dot = warp_sum(dot);
    if (lane == 0) out[row] = xs - 2.f * dot + q_sq;
  }
}

template <bool VEC>
cudaError_t launch(const float* x, const float* q, float* out, int64_t n, int dd,
                   cudaStream_t s) {
  const size_t smem = static_cast<size_t>(dd) * sizeof(float);
  const cudaError_t err = allow_smem(bruteforce_kernel<VEC>, smem);
  if (err != cudaSuccess) return err;
  bruteforce_kernel<VEC><<<grid_for(n, kWarps), kThreads, smem, s>>>(x, q, out, n, dd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, dd] f32, q [dd] f32, out [n] f32, all contiguous on the current
// device.  Returns a cudaError_t (0 = launched).
int ls_bruteforce_distances(const void* x, const void* q, void* out, int64_t n, int dd,
                            void* stream) {
  if (n <= 0) return 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* qf = static_cast<const float*>(q);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dd % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch<true>(xf, qf, o, n, dd, s);
  return launch<false>(xf, qf, o, n, dd, s);
}

}  // extern "C"
