// Packed 1-bit code x query products for the IVF-RaBitQ search, for Hopper
// (sm_90a).  Built by lakesoul_tpu_torch/_build.py into a shared library with
// a plain C interface and bound through ctypes
// (lakesoul_tpu_torch/vector/kernels.py).
//
// Codes are RaBitQ sign bits packed MSB-first, as np.packbits writes them:
// bit j of byte p of a row stands for dimension 8p + j.  Both kernels unpack
// on chip (registers, or a per-chunk tile in shared memory); device memory
// holds packed codes only, the bit matrix never exists there.  Dimensions at or past d (the query width) get zero weight,
// which is what the reference's zero-padded query gives them.
//
// ls_packed_dot_batch replaces lakesoul_tpu/vector/kernels.py
//   packed_dot_batch_pallas -> _packed_dot_batch_kernel.
//   bits [N, 8*d8] x Q[nq, d]^T -> [N, nq] f32.  At the serving shape
//   (N = 1,048,576, d = 512, nq = 256) it reads 67 MB of codes and writes
//   1.07 GB, ~0.34 ms at 3.35 TB/s, but does 2.75e11 f32 multiply-adds,
//   ~4.1 ms at the 67 TFLOP/s non-tensor-core f32 peak: it is bound by
//   operations, so the design is a register-tiled f32 product on the CUDA
//   cores: each thread owns 8 rows x 8 queries in 64 accumulators, and each
//   step reads 4 float4 from shared memory for 64 FMAs.  A block stages 32
//   dimensions (4 code bytes) at a time: the code bytes are unpacked ONCE
//   per block into a float bit tile in shared memory (the bit matrix exists
//   only there, per chunk), beside the chunk of queries.  128 rows x 64
//   queries take 25 KB, under the 48 KB static limit for any d and nq.
//
// ls_packed_dot replaces lakesoul_tpu/vector/kernels.py
//   packed_dot_pallas -> _packed_dot_kernel.
//   bits [N, 8*d8] x q[d] -> [N] f32.  At N = 1,048,576, d = 512 it moves
//   71 MB (~21 us at 3.35 TB/s) for 5.4e8 FLOP: bound by bytes.  Design: the
//   query sits in shared memory (2 KB at d = 512, dynamic size), one thread
//   computes one row, reading its bytes 16 or 4 at a time where the row
//   stride and base allow it.
//
// ls_packed_scan replaces lakesoul_tpu/vector/kernels.py
//   packed_scan_pallas -> _packed_scan_kernel.
//   One cluster's RaBitQ estimate: bq = bits . q as in ls_packed_dot, then
//   norm^2 + |q|^2 - 2 * norm * ((2 * bq - sum(q)) / sqrt(d)) / factor -> [N]
//   f32, fused.  sum(q) and |q|^2 are reduced in every block over the
//   zero-padded query in shared memory, as the TPU body reduces its padded
//   query; d is the caller's argument, not the query's length.  At
//   N = 1,048,576, d = 512 it moves 75.5 MB (~23 us at 3.35 TB/s) for
//   ~1.1e9 FLOP: bound by bytes, like ls_packed_dot, whose row loop it shares.

#include "ls_common.cuh"

namespace {

// packed_dot_batch: each thread owns an 8 x 8 tile of (rows, queries) in 64
// register accumulators; a block of RG x QG threads owns 8*RG rows x 8*QG
// queries and walks d in chunks of 32 dimensions (4 code bytes).
constexpr int kTile = 8;        // rows and queries per thread
constexpr int kChunkBytes = 4;  // code bytes per staged chunk
constexpr int kChunkDims = kChunkBytes * 8;

// 1.0f where bit (7 - j) of `byte` is set, else 0.0f, without an
// int-to-float conversion: move the bit to the sign position, spread it
// with an arithmetic shift and mask the bits of 1.0f.
__device__ __forceinline__ float bit_as_float(uint32_t byte, int j) {
  const int spread = static_cast<int>(byte << (24 + j)) >> 31;
  return __int_as_float(spread & 0x3f800000);
}

template <int RG, int QG>
__global__ void __launch_bounds__(RG * QG)
packed_dot_batch_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ q,
                        float* __restrict__ out, int64_t n, int d8, int d, int nq) {
  constexpr int kThreads = RG * QG;
  constexpr int kBlockRows = kTile * RG;
  constexpr int kBlockQueries = kTile * QG;
  // the chunk's bits, unpacked once per block (not once per query group),
  // and the chunk's queries, both dimension-major so a thread reads its 8
  // rows and its 8 queries as two float4 each
  __shared__ __align__(16) float bits_s[kChunkDims][kBlockRows];
  __shared__ __align__(16) float q_s[kChunkDims][kBlockQueries + 4];

  const int tid = threadIdx.x;
  const int tx = tid % RG;  // row group: rows 4tx..4tx+3 and 4RG+4tx..4RG+4tx+3
  const int ty = tid / RG;  // query group, likewise over 4QG
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBlockRows;
  const int q0 = blockIdx.y * kBlockQueries;

  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int c = 0; c < kTile; ++c) acc[i][c] = 0.f;

  for (int p0 = 0; p0 < d8; p0 += kChunkBytes) {
    // bytes [p0, p0 + 4) of rows [row0, row0 + kBlockRows), zero past d8 and
    // n; consecutive threads take consecutive rows: conflict-free stores
    for (int e = tid; e < kBlockRows * kChunkBytes; e += kThreads) {
      const int r = e % kBlockRows;
      const int b = e / kBlockRows;
      const int64_t row = row0 + r;
      const int byte = p0 + b;
      const uint32_t v = (row < n && byte < d8) ? codes[row * d8 + byte] : 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) bits_s[b * 8 + j][r] = bit_as_float(v, j);
    }
    // dims [8*p0, 8*p0 + 32) of queries [q0, q0 + kBlockQueries), zero past
    // d (the bits past d get zero weight) and past nq
    for (int e = tid; e < kChunkDims * kBlockQueries; e += kThreads) {
      const int k = e % kChunkDims;
      const int qq = e / kChunkDims;
      const int dim = p0 * 8 + k;
      const int qi = q0 + qq;
      q_s[k][qq] = (dim < d && qi < nq) ? q[static_cast<int64_t>(qi) * d + dim] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunkDims; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&bits_s[k][4 * tx]);
      const float4 a1 = *reinterpret_cast<const float4*>(&bits_s[k][4 * RG + 4 * tx]);
      const float4 b0 = *reinterpret_cast<const float4*>(&q_s[k][4 * ty]);
      const float4 b1 = *reinterpret_cast<const float4*>(&q_s[k][4 * QG + 4 * ty]);
      const float a[kTile] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kTile] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int c = 0; c < kTile; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int64_t row = row0 + (i < 4 ? 4 * tx + i : 4 * RG + 4 * tx + i - 4);
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      const int qi = q0 + (c < 4 ? 4 * ty + c : 4 * QG + 4 * ty + c - 4);
      if (qi < nq) out[row * nq + qi] = acc[i][c];
    }
  }
}

template <int RG, int QG>
cudaError_t launch_batch(const uint8_t* codes, const float* q, float* out, int64_t n, int d8,
                         int d, int nq, cudaStream_t stream) {
  constexpr int kBlockRows = kTile * RG;
  constexpr int kBlockQueries = kTile * QG;
  const dim3 grid(static_cast<unsigned>((n + kBlockRows - 1) / kBlockRows),
                  static_cast<unsigned>((nq + kBlockQueries - 1) / kBlockQueries));
  packed_dot_batch_kernel<RG, QG><<<grid, RG * QG, 0, stream>>>(codes, q, out, n, d8, d, nq);
  return cudaGetLastError();
}

// bits . q_sm over one row of d8 code bytes, q_sm zero past d; W = code
// bytes per load (1, 4 or 16).
template <int W>
__device__ __forceinline__ float row_dot(const uint8_t* __restrict__ c, const float* q_sm,
                                         int d8) {
  float acc = 0.f;
  for (int p = 0; p < d8; p += W) {
    uint32_t words[(W + 3) / 4];
    if constexpr (W == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(c + p);
      words[0] = v.x; words[1] = v.y; words[2] = v.z; words[3] = v.w;
    } else if constexpr (W == 4) {
      words[0] = *reinterpret_cast<const uint32_t*>(c + p);
    } else {
      words[0] = c[p];
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      // little-endian: byte p + w is byte (w % 4) of word w / 4
      const uint32_t byte = (words[w / 4] >> (8 * (w % 4))) & 0xffu;
      const float* qk = q_sm + (p + w) * 8;  // same address across the warp
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = fmaf(bit_as_float(byte, j), qk[j], acc);
    }
  }
  return acc;
}

// packed_dot: one thread per row; W = code bytes per load (1, 4 or 16)
template <int W>
__global__ void __launch_bounds__(256)
packed_dot_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ q,
                  float* __restrict__ out, int64_t n, int d8, int d) {
  extern __shared__ float q_sm[];  // 8 * d8 floats, zero past d
  for (int k = threadIdx.x; k < 8 * d8; k += blockDim.x) q_sm[k] = k < d ? q[k] : 0.f;
  __syncthreads();
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  out[row] = row_dot<W>(codes + row * d8, q_sm, d8);
}

// packed_scan: one thread per row, as packed_dot, with the estimator fused.
template <int W>
__global__ void __launch_bounds__(256)
packed_scan_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ q,
                   const float* __restrict__ norms, const float* __restrict__ factors,
                   float* __restrict__ out, int64_t n, int d8, int qlen, float sqrt_d) {
  extern __shared__ float q_sm[];  // 8 * d8 floats, zero past qlen
  __shared__ float red[2][8];      // per-warp partial sum(q), |q|^2
  float s = 0.f, sq = 0.f;
  for (int k = threadIdx.x; k < 8 * d8; k += blockDim.x) {
    const float v = k < qlen ? q[k] : 0.f;
    q_sm[k] = v;
    s += v;
    sq = fmaf(v, v, sq);
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = sq;
  }
  __syncthreads();
  float qsum = 0.f, qsq = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    qsum += red[0][w];
    qsq += red[1][w];
  }
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float bq = row_dot<W>(codes + row * d8, q_sm, d8);
  const float nrm = norms[row];
  const float est_rq = nrm * ((2.f * bq - qsum) / sqrt_d) / factors[row];
  out[row] = nrm * nrm + qsq - 2.f * est_rq;
}

template <int W>
cudaError_t launch_single(const uint8_t* codes, const float* q, float* out, int64_t n, int d8,
                          int d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d8) * 8 * sizeof(float);
  const cudaError_t err = allow_smem(packed_dot_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  packed_dot_kernel<W><<<blocks, threads, smem, stream>>>(codes, q, out, n, d8, d);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_scan(const uint8_t* codes, const float* q, const float* norms,
                        const float* factors, float* out, int64_t n, int d8, int qlen,
                        float sqrt_d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d8) * 8 * sizeof(float);
  const cudaError_t err = allow_smem(packed_scan_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  packed_scan_kernel<W><<<blocks, threads, smem, stream>>>(codes, q, norms, factors, out, n, d8,
                                                           qlen, sqrt_d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// codes [n, d8] uint8, q [d] f32, out [n] f32, all contiguous on the current
// device; d <= 8 * d8.  Returns a cudaError_t (0 = launched).
int ls_packed_dot(const void* codes, const void* q, void* out, int64_t n, int d8, int d,
                  void* stream) {
  if (n <= 0) return 0;
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* qf = static_cast<const float*>(q);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const auto addr = reinterpret_cast<uintptr_t>(codes);
  if (d8 % 16 == 0 && addr % 16 == 0) return launch_single<16>(c, qf, o, n, d8, d, s);
  if (d8 % 4 == 0 && addr % 4 == 0) return launch_single<4>(c, qf, o, n, d8, d, s);
  return launch_single<1>(c, qf, o, n, d8, d, s);
}

// codes [n, d8] uint8, q [nq, d] f32, out [n, nq] f32, all contiguous on the
// current device; d <= 8 * d8.  qg picks the block's query tile, 8 * qg
// queries (2, 4 or 8; the caller picks the narrowest that holds nq, so the
// endpoint's batches of 16 do not pay for 64).  An 8-query tile (32 x 1
// threads, 256 rows) lost to the 16-query one even at nq = 8 on an H100, so
// there is none.  Returns a cudaError_t (0 = launched).
int ls_packed_dot_batch(const void* codes, const void* q, void* out, int64_t n, int d8, int d,
                        int nq, int qg, void* stream) {
  if (n <= 0 || nq <= 0) return 0;
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* qf = static_cast<const float*>(q);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (qg) {
    case 2: return launch_batch<16, 2>(c, qf, o, n, d8, d, nq, s);
    case 4: return launch_batch<16, 4>(c, qf, o, n, d8, d, nq, s);
    case 8: return launch_batch<16, 8>(c, qf, o, n, d8, d, nq, s);
    default: return cudaErrorInvalidValue;
  }
}

// codes [n, d8] uint8, q [qlen] f32 (qlen <= 8 * d8), norms and factors [n]
// f32, out [n] f32, all contiguous on the current device.  sqrt_d is sqrt(d)
// rounded to f32.  Returns a cudaError_t (0 = launched).
int ls_packed_scan(const void* codes, const void* q, const void* norms, const void* factors,
                   void* out, int64_t n, int d8, int qlen, float sqrt_d, void* stream) {
  if (n <= 0) return 0;
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* qf = static_cast<const float*>(q);
  const auto* nm = static_cast<const float*>(norms);
  const auto* fc = static_cast<const float*>(factors);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const auto addr = reinterpret_cast<uintptr_t>(codes);
  if (d8 % 16 == 0 && addr % 16 == 0) return launch_scan<16>(c, qf, nm, fc, o, n, d8, qlen, sqrt_d, s);
  if (d8 % 4 == 0 && addr % 4 == 0) return launch_scan<4>(c, qf, nm, fc, o, n, d8, qlen, sqrt_d, s);
  return launch_scan<1>(c, qf, nm, fc, o, n, d8, qlen, sqrt_d, s);
}

}  // extern "C"
