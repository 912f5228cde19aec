// Packed 1-bit code x query products for the IVF-RaBitQ search, for Hopper
// (sm_90a).  Built by lakesoul_tpu_torch/_build.py into a shared library with
// a plain C interface and bound through ctypes
// (lakesoul_tpu_torch/vector/kernels.py).
//
// Codes are RaBitQ sign bits packed MSB-first, as np.packbits writes them:
// bit j of byte p of a row stands for dimension 8p + j.  Every kernel here
// unpacks in registers; device and shared memory hold packed codes only, the
// bit matrix never exists anywhere.  Dimensions at or past d (the query
// width) get zero weight, which is what the reference's zero-padded query
// gives them.
//
// ls_packed_dot_batch and ls_packed_estimate_batch are the two modes of one
// kernel, which replaces lakesoul_tpu/vector/kernels.py
//   packed_dot_batch_pallas -> _packed_dot_batch_kernel
// and, in its second mode, also the jnp estimator the reference wraps around
// that call (_fused_search_resident_batch, kernels.py:318-331).
//   Product mode: bits [N, 8*d8] x Q[nq, d]^T -> [N, nq] f32.
//   Estimate mode: the same product, then per (query, row) the RaBitQ
//   estimate in the global query frame, +inf where the row's cluster is not
//   probed for the query, written as [nq, N] f32, the layout the top-k reads.
//   At the serving shape (N = 1,048,576, d = 512, nq = 256) the product is
//   2.75e11 multiply-adds.  On the CUDA cores (67 TFLOP/s f32) that alone is
//   4.1 ms; the design moves it to the tensor cores.  Bits are exactly 0 or 1
//   in bf16, and each f32 query splits exactly into three bf16 planes
//   (hi = bf16(q), mid = bf16(q - hi), lo = bf16(q - hi - mid), 24 mantissa
//   bits in all), so three bf16 products with f32 accumulators give the f32
//   product up to summation order: 8.25e11 FLOP, 0.83 ms at the 989 TFLOP/s
//   bf16 peak, against 1.14 GB of traffic (0.34 ms at 3.35 TB/s).  Bound by
//   operations.
//   Instruction: mma.sync.m16n8k16 (bf16 in, f32 accumulate), not wgmma.
//   wgmma wants its B operand in shared memory in a swizzled layout, so the
//   bits would have to be unpacked there; mma.sync takes B from registers,
//   where each thread builds its fragment (0x3F80 or 0 per bf16) straight
//   from two packed code bytes.  mma.sync does not reach wgmma's rate; wgmma
//   is the next step.
//   Layout: M = queries (the A operand, three bf16 planes of the block's
//   queries, split once in the prologue and kept in shared memory for the
//   block's life), N = code rows (the B operand), K = dimensions.  A block
//   of 8 warps owns BM queries and walks row tiles of BN rows (a persistent
//   grid-stride loop, so the query planes are loaded once per block).  A
//   warp owns 16*MT queries x 64 rows.  Code tiles of 16 bytes a row (128
//   dimensions, 8 k-steps) are staged packed with cp.async, double-buffered;
//   each thread reads 4 bytes of a row a pair of k-steps and expands them
//   into its B fragments with a byte permute, a mask and a multiply.
//   Tile invariance: every (row, query) value is summed in the same order
//   whatever the tile: k-steps in order, and in each the hi, mid and lo
//   products into one accumulator.  A query's estimates do not depend on nq
//   or on the query tile (chip_smoke.py checks this bitwise).
//   Epilogue: in product mode each value goes to out[row * nq + query]; in
//   estimate mode a thread's two adjacent rows go out as one float2, and
//   the 4 threads of a quad cover 8 consecutive rows: 32-byte segments along
//   N.  Each tile's per-row data (cluster id, norm, factor, code_dot_c)
//   is staged into shared memory with cp.async beside the tile's first code
//   chunk, so the epilogue, which no other work overlaps, waits on no
//   device-memory load for it.  The estimator repeats _estimate's order of operations, in
//   round-to-nearest intrinsics that the compiler cannot contract to FMAs,
//   and runs only where the row's cluster is probed for the query (a few
//   per cent of the values at the slice's nprobe): the rest are +inf.
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
//   One cluster's RaBitQ estimate: bq = bits . q, then
//   norm^2 + |q|^2 - 2 * norm * ((2 * bq - sum(q)) / sqrt(d)) / factor -> [N]
//   f32, fused.  sum(q) and |q|^2 are reduced in every block over the
//   zero-padded query in shared memory, as the TPU body reduces its padded
//   query; d is the caller's argument, not the query's length.  Bound by
//   bytes (75.5 MB at N = 1,048,576, d = 512, ~23 us), but its callers scan
//   one probed cluster at a time, a few thousand rows: there the launch
//   shape decides.  Four lanes share a row (16 bytes each at d8 = 64) and
//   reduce with two shuffles, so a 3,913-row cluster spreads over 62 blocks
//   and each lane's dependent chain covers a quarter of the row.  Past one
//   resident wave of blocks the rows are walked grid-stride, so a large set
//   does not repeat the query prologue in every block.  The query in shared
//   memory is padded so the four lanes of a row read four bank groups with
//   16-byte loads.

#include <cuda_bf16.h>

#include "ls_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// packed_dot_batch / packed_estimate_batch: bf16 tensor-core product
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;   // 8 warps a block
constexpr int kChunk = 16;      // code bytes a row per staged chunk: 128 dims, 8 k-steps
constexpr int kWarpRows = 64;   // code rows a warp owns: 8 n-tiles of 8
constexpr int kNTiles = kWarpRows / 8;

// The estimator's per-row and per-(cluster, query) tables; unused in
// product mode.
struct EstimateArgs {
  const float* norms;
  const float* factors;
  const float* cdc;        // code_dot_c
  const int64_t* cluster;  // cluster id of each row
  const uint8_t* probe;    // [nlist, nq] bool
  const float* csq;        // [nlist, nq]
  const float* csum;       // [nlist, nq]
  float sqrt_d;
};

// Shared memory of a block: the query planes [3][BM][qstride] bf16
// (qstride = kp + 8, so the 8 rows an ldmatrix phase reads fall in 8
// different bank groups), two code chunks [2][BN][kChunk], and in estimate
// mode the per-row data of two tiles (cluster id, norm, factor, code_dot_c).
__host__ __device__ constexpr int padded_dims(int d8) { return (d8 + kChunk - 1) / kChunk * kChunk * 8; }

constexpr int kRowBytes = 8 + 3 * 4;  // int64 cluster id, three f32

__host__ __device__ constexpr size_t batch_smem(int bm, int bn, int d8, bool estimate) {
  return static_cast<size_t>(3) * bm * (padded_dims(d8) + 8) * 2 + 2ull * bn * kChunk +
         (estimate ? 2ull * bn * kRowBytes : 0);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16 bf16, row-major) x b (16 x 8 bf16, col-major), f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One B-fragment register from byte q of `lo` / `hi` (each byte 0 or 1):
// bf16 1.0 (0x3F80) or 0 in the low half from `lo`, in the high half from
// `hi`.
template <int Q>
__device__ __forceinline__ uint32_t bits_bf16x2(uint32_t lo, uint32_t hi) {
  constexpr uint32_t sel = Q | (Q << 4) | ((4 + Q) << 8) | ((4 + Q) << 12);
  return (__byte_perm(lo, hi, sel) & 0x00010001u) * 0x3F80u;
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_value(uint16_t b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}

// MT m-tiles of 16 queries a warp; WM x WN warps; BM = 16 * MT * WM queries,
// BN = 64 * WN rows a block.  ALIGNED: 16-byte cp.async of the code tile
// (d8 % 16 == 0 and a 16-byte aligned base), else byte loads.
template <int MT, int WM, int WN, bool ALIGNED, bool ESTIMATE>
__global__ void __launch_bounds__(kThreads)
packed_batch_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ q,
                    float* __restrict__ out, int64_t n, int d8, int d, int nq, EstimateArgs est) {
  static_assert(WM * WN * 32 == kThreads, "8 warps a block");
  constexpr int BM = 16 * MT * WM;
  constexpr int BN = kWarpRows * WN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = padded_dims(d8);
  const int qstride = kp + 8;
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem);  // [3][BM][qstride]
  uint8_t* c_s = smem + static_cast<size_t>(3) * BM * qstride * 2;  // [2][BN][kChunk]
  int64_t* cl_s = reinterpret_cast<int64_t*>(c_s + 2 * BN * kChunk);  // [2][BN], estimate mode
  float* rv_s = reinterpret_cast<float*>(cl_s + 2 * BN);  // [3][2][BN]: norm, factor, cdc

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * BM;

  // prologue: the block's queries, zero past d and nq, split into three
  // bf16 planes with the arithmetic of split_bf16x3 (vector/kernels.py)
  for (int e = tid; e < BM * kp; e += kThreads) {
    const int m = e / kp, k = e % kp;
    const float v = (k < d && q0 + m < nq) ? q[static_cast<int64_t>(q0 + m) * d + k] : 0.f;
    const uint16_t hi = bf16_bits(v);
    const float r1 = __fsub_rn(v, bf16_value(hi));
    const uint16_t mid = bf16_bits(r1);
    const uint16_t lo = bf16_bits(__fsub_rn(r1, bf16_value(mid)));
    const int at = m * qstride + k;
    q_s[at] = hi;
    q_s[BM * qstride + at] = mid;
    q_s[2 * BM * qstride + at] = lo;
  }

  const int64_t tiles = (n + BN - 1) / BN;
  const int kch = kp / (8 * kChunk);
  const int64_t my_tiles =
      blockIdx.x < tiles ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int64_t steps = my_tiles * kch;

  // stage step `it` (tile, chunk) into buffer `buf`
  auto stage = [&](int64_t it, int buf) {
    const int64_t row0 = (blockIdx.x + (it / kch) * gridDim.x) * BN;
    const int c = static_cast<int>(it % kch);
    uint8_t* dst = c_s + buf * BN * kChunk;
    if constexpr (ALIGNED) {
      for (int r = tid; r < BN; r += kThreads) {
        const int64_t row = row0 + r;
        const uint8_t* src = row < n ? codes + row * d8 + c * kChunk : codes;
        cp_async16(dst + r * kChunk, src, row < n ? kChunk : 0);
      }
    } else {
      for (int e = tid; e < BN * kChunk; e += kThreads) {
        const int64_t row = row0 + e / kChunk;
        const int byte = c * kChunk + e % kChunk;
        dst[e] = (row < n && byte < d8) ? codes[row * d8 + byte] : 0;
      }
    }
    if constexpr (ESTIMATE) {
      // a tile's per-row data rides with its first chunk, into the tile's
      // parity buffer, so the epilogue reads it from shared memory
      if (c == 0) {
        const int tb = static_cast<int>((it / kch) & 1);
        for (int r = tid; r < BN; r += kThreads) {
          const int64_t row = row0 + r;
          const int64_t src = row < n ? row : 0;
          const int ok = row < n;
          cp_async_elem<8>(cl_s + tb * BN + r, est.cluster + src, 8 * ok);
          cp_async_elem<4>(rv_s + (0 * 2 + tb) * BN + r, est.norms + src, 4 * ok);
          cp_async_elem<4>(rv_s + (1 * 2 + tb) * BN + r, est.factors + src, 4 * ok);
          cp_async_elem<4>(rv_s + (2 * 2 + tb) * BN + r, est.cdc + src, 4 * ok);
        }
      }
    }
    cp_async_commit();
  };

  float acc[MT][kNTiles][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // this thread's bits of a code byte: dims 2t and 2t + 1 of its 8
  const int shift = 6 - 2 * t;
  const uint16_t* a_base = q_s + (wm * MT * 16 + (lane & 15)) * qstride + (lane >> 4) * 8;

  if (steps > 0) stage(0, 0);
  for (int64_t it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      stage(it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c = static_cast<int>(it % kch);
    const uint8_t* tile_s = c_s + (it & 1) * BN * kChunk + (wn * kWarpRows + g) * kChunk;
#pragma unroll
    for (int s2 = 0; s2 < kChunk / 4; ++s2) {
      // bytes 4*s2 .. 4*s2+3 of each of the warp's rows: k-steps 2*s2, 2*s2+1
      uint32_t lo[kNTiles], hi[kNTiles];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(tile_s + j * 8 * kChunk + s2 * 4);
        const uint32_t m = w >> shift;
        lo[j] = (m >> 1) & 0x01010101u;  // dim 2t of each byte: the low bf16
        hi[j] = m & 0x01010101u;         // dim 2t + 1: the high bf16
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = c * 8 + s2 * 2 + h;  // the k-step, in order
        uint32_t b[kNTiles][2];
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          b[j][0] = h == 0 ? bits_bf16x2<0>(lo[j], hi[j]) : bits_bf16x2<2>(lo[j], hi[j]);
          b[j][1] = h == 0 ? bits_bf16x2<1>(lo[j], hi[j]) : bits_bf16x2<3>(lo[j], hi[j]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t a[3][4];
#pragma unroll
          for (int p = 0; p < 3; ++p)
            ldmatrix_x4(a[p], a_base + p * BM * qstride + i * 16 * qstride + ks * 16);
#pragma unroll
          for (int j = 0; j < kNTiles; ++j)
#pragma unroll
            for (int p = 0; p < 3; ++p) mma_bf16(acc[i][j], a[p], b[j][0], b[j][1]);
        }
      }
    }

    if (c == kch - 1) {  // the tile's last chunk: epilogue, then a fresh sum
      const int64_t row_base = (blockIdx.x + (it / kch) * gridDim.x) * BN + wn * kWarpRows + 2 * t;
      const int qb = q0 + wm * MT * 16 + g;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int64_t r0 = row_base + j * 8;
        if constexpr (!ESTIMATE) {
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = qb + i * 16 + (e >> 1) * 8;
              const int64_t row = r0 + (e & 1);
              if (qi < nq && row < n) out[row * nq + qi] = acc[i][j][e];
            }
        } else {
          // the tables never alias the output: their loads may run ahead
          const uint8_t* __restrict__ probe = est.probe;
          const float* __restrict__ csq = est.csq;
          const float* __restrict__ csum = est.csum;
          const int tb = static_cast<int>((it / kch) & 1);
          float nrm[2], fac[2], cdc[2];
          int64_t cl[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // rows past n read zeros; their stores are guarded
            const int r = wn * kWarpRows + j * 8 + 2 * t + e;
            cl[e] = cl_s[tb * BN + r];
            nrm[e] = rv_s[(0 * 2 + tb) * BN + r];
            fac[e] = rv_s[(1 * 2 + tb) * BN + r];
            cdc[e] = rv_s[(2 * 2 + tb) * BN + r];
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int qi = qb + i * 16 + hh * 8;
              if (qi >= nq) continue;
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                // _estimate (vector/kernels.py), operation for operation,
                // only where the cluster is probed: +inf elsewhere
                const int64_t at = cl[e] * nq + qi;
                v[e] = __int_as_float(0x7f800000);
                if (__ldg(probe + at)) {
                  const float bq = acc[i][j][hh * 2 + e];
                  const float dot = __fdiv_rn(
                      __fsub_rn(__fmul_rn(2.f, __fsub_rn(cdc[e], bq)), __ldg(csum + at)),
                      est.sqrt_d);
                  v[e] = __fadd_rn(__fadd_rn(__fmul_rn(nrm[e], nrm[e]), __ldg(csq + at)),
                                   __fdiv_rn(__fmul_rn(__fmul_rn(2.f, nrm[e]), dot), fac[e]));
                }
              }
              float* o = out + static_cast<int64_t>(qi) * n + r0;
              if ((n & 1) == 0 && r0 + 1 < n) {
                *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
              } else {
                if (r0 < n) o[0] = v[0];
                if (r0 + 1 < n) o[1] = v[1];
              }
            }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      }
    }
    __syncthreads();  // the buffer just read is staged into next
  }
}

template <int MT, int WM, int WN, bool ESTIMATE>
cudaError_t launch_batch_tile(const uint8_t* codes, const float* q, float* out, int64_t n,
                              int d8, int d, int nq, const EstimateArgs& est,
                              cudaStream_t stream) {
  constexpr int BM = 16 * MT * WM;
  constexpr int BN = kWarpRows * WN;
  const size_t smem = batch_smem(BM, BN, d8, ESTIMATE);
  const bool aligned = d8 % kChunk == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const auto kernel = aligned ? packed_batch_kernel<MT, WM, WN, true, ESTIMATE>
                              : packed_batch_kernel<MT, WM, WN, false, ESTIMATE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 132;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // at most one wave of resident blocks over the query tiles (a partial
  // second wave would double the time); each block walks row tiles
  const int64_t q_tiles = (nq + BM - 1) / BM;
  const int64_t row_tiles = (n + BN - 1) / BN;
  const int64_t fit = static_cast<int64_t>(sms) * per_sm / q_tiles;
  const int64_t want = fit > 0 ? fit : 1;
  const unsigned gx = static_cast<unsigned>(row_tiles < want ? row_tiles : want);
  kernel<<<dim3(gx, static_cast<unsigned>(q_tiles)), kThreads, smem, stream>>>(codes, q, out, n,
                                                                              d8, d, nq, est);
  return cudaGetLastError();
}

// The query tile `bm` (16, 32 or 64 queries a block), narrowed while its
// query planes do not fit in shared memory: 64 queries take d up to 512, 32
// up to 1024, 16 up to 1920; past that the launch is refused.  The tile
// changes speed only: every value is tile-invariant.
template <bool ESTIMATE>
cudaError_t launch_batch(const uint8_t* codes, const float* q, float* out, int64_t n, int d8,
                         int d, int nq, int bm, const EstimateArgs& est, cudaStream_t stream) {
  int dev = 0, limit = 232448;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t cap = static_cast<size_t>(limit);
  if (bm == 64 && batch_smem(64, 4 * kWarpRows, d8, ESTIMATE) > cap) bm = 32;
  if (bm == 32 && batch_smem(32, 8 * kWarpRows, d8, ESTIMATE) > cap) bm = 16;
  if (bm == 16 && batch_smem(16, 8 * kWarpRows, d8, ESTIMATE) > cap) return cudaErrorInvalidValue;
  switch (bm) {
    case 16: return launch_batch_tile<1, 1, 8, ESTIMATE>(codes, q, out, n, d8, d, nq, est, stream);
    case 32: return launch_batch_tile<2, 1, 8, ESTIMATE>(codes, q, out, n, d8, d, nq, est, stream);
    case 64: return launch_batch_tile<2, 2, 4, ESTIMATE>(codes, q, out, n, d8, d, nq, est, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// packed_dot and packed_scan: CUDA-core row loops
// ---------------------------------------------------------------------------

// 1.0f where bit (7 - j) of `byte` is set, else 0.0f, without an
// int-to-float conversion: move the bit to the sign position, spread it
// with an arithmetic shift and mask the bits of 1.0f.
__device__ __forceinline__ float bit_as_float(uint32_t byte, int j) {
  const int spread = static_cast<int>(byte << (24 + j)) >> 31;
  return __int_as_float(spread & 0x3f800000);
}

// W code bytes at c + p (W = 1, 4 or 16) as little-endian words
template <int W>
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ c, int p,
                                           uint32_t (&words)[(W + 3) / 4]) {
  if constexpr (W == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(c + p);
    words[0] = v.x; words[1] = v.y; words[2] = v.z; words[3] = v.w;
  } else if constexpr (W == 4) {
    words[0] = *reinterpret_cast<const uint32_t*>(c + p);
  } else {
    words[0] = c[p];
  }
}

// acc += bits . qk over W code bytes, qk the query floats of their dims in
// shared memory, 16-byte aligned: each byte's 8 floats are two float4 loads
template <int W>
__device__ __forceinline__ float bytes_dot(const uint32_t (&words)[(W + 3) / 4],
                                           const float* qk, float acc) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t byte = (words[w / 4] >> (8 * (w % 4))) & 0xffu;  // byte w
    const float4 lo = *reinterpret_cast<const float4*>(qk + 8 * w);
    const float4 hi = *reinterpret_cast<const float4*>(qk + 8 * w + 4);
    const float qv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(bit_as_float(byte, j), qv[j], acc);
  }
  return acc;
}

// packed_dot: one thread per row; W = code bytes per load (1, 4 or 16)
template <int W>
__global__ void __launch_bounds__(256)
packed_dot_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ q,
                  float* __restrict__ out, int64_t n, int d8, int d) {
  extern __shared__ __align__(16) float q_sm[];  // 8 * d8 floats, zero past d
  for (int k = threadIdx.x; k < 8 * d8; k += blockDim.x) q_sm[k] = k < d ? q[k] : 0.f;
  __syncthreads();
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint8_t* c = codes + row * d8;
  float acc = 0.f;
  for (int p = 0; p < d8; p += W) {
    uint32_t words[(W + 3) / 4];
    load_bytes<W>(c, p, words);
    acc = bytes_dot<W>(words, q_sm + p * 8, acc);  // same address across the warp
  }
  out[row] = acc;
}

constexpr int kScanLanes = 4;  // lanes a row in packed_scan

// packed_scan: kScanLanes lanes a row, each taking every kScanLanes-th run
// of W bytes, then a shuffle reduce; the estimator fused.  The query sits in
// shared memory with 4 pad floats after every 8*W, so the lanes of a row,
// 8*W + 4 floats apart, read different banks and each run stays 16-byte
// aligned for bytes_dot's float4 loads.
template <int W>
__global__ void __launch_bounds__(256)
packed_scan_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ q,
                   const float* __restrict__ norms, const float* __restrict__ factors,
                   float* __restrict__ out, int64_t n, int d8, int qlen, float sqrt_d) {
  extern __shared__ __align__(16) float q_sm[];  // 8 * d8 floats + pads, zero past qlen
  __shared__ float red[2][8];      // per-warp partial sum(q), |q|^2
  float s = 0.f, sq = 0.f;
  for (int k = threadIdx.x; k < 8 * d8; k += blockDim.x) {
    const float v = k < qlen ? q[k] : 0.f;
    q_sm[k + 4 * (k / (8 * W))] = v;
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
  // grid-stride over groups of 32 / kScanLanes rows, one group a warp; the
  // loop bound is the warp's first row, so every lane of a warp runs the
  // same trips and takes part in the shuffles, rows past n included
  static_assert(32 % kScanLanes == 0, "the lanes of a row divide a warp");
  const int part = lane % kScanLanes;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (blockDim.x / kScanLanes);
  for (int64_t first = (static_cast<int64_t>(blockIdx.x) * blockDim.x + warp * 32) / kScanLanes;
       first < n; first += stride) {
    const int64_t row = first + lane / kScanLanes;
    float bq = 0.f;
    if (row < n) {
      const uint8_t* c = codes + row * d8;
      for (int p = part * W; p < d8; p += kScanLanes * W) {
        uint32_t words[(W + 3) / 4];
        load_bytes<W>(c, p, words);
        bq = bytes_dot<W>(words, q_sm + p * 8 + 4 * (p / W), bq);
      }
    }
#pragma unroll
    for (int o = 1; o < kScanLanes; o <<= 1) bq += __shfl_xor_sync(0xffffffffu, bq, o);
    if (row < n && part == 0) {
      const float nrm = norms[row];
      const float est_rq = nrm * ((2.f * bq - qsum) / sqrt_d) / factors[row];
      out[row] = nrm * nrm + qsq - 2.f * est_rq;
    }
  }
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
  const size_t smem = (static_cast<size_t>(d8) * 8 + 4 * (d8 / W + 1)) * sizeof(float);
  const cudaError_t err = allow_smem(packed_scan_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  // one block a 64-row group, capped at one resident wave (8 blocks of 256
  // on each SM): a small cluster still spreads over many SMs, a large set
  // pays the query prologue once a block, not once a 64 rows
  const int threads = 256;
  const unsigned blocks = grid_for(n * kScanLanes, threads, 8);
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

// Product mode.  codes [n, d8] uint8, q [nq, d] f32, out [n, nq] f32, all
// contiguous on the current device; d <= 8 * d8.  bm is the query tile (16,
// 32 or 64 queries a block; see launch_batch).  Returns a cudaError_t.
int ls_packed_dot_batch(const void* codes, const void* q, void* out, int64_t n, int d8, int d,
                        int nq, int bm, void* stream) {
  if (n <= 0 || nq <= 0) return 0;
  return launch_batch<false>(static_cast<const uint8_t*>(codes), static_cast<const float*>(q),
                             static_cast<float*>(out), n, d8, d, nq, bm, EstimateArgs{},
                             static_cast<cudaStream_t>(stream));
}

// Estimate mode.  As ls_packed_dot_batch, plus norms, factors, code_dot_c
// [n] f32 and cluster [n] int64 (each in [0, nlist)), probe [nlist, nq] bool,
// csq and csum [nlist, nq] f32; out [nq, n] f32.  sqrt_d is sqrt(d) rounded
// to f32.  Returns a cudaError_t.
int ls_packed_estimate_batch(const void* codes, const void* q, const void* norms,
                             const void* factors, const void* cdc, const void* cluster,
                             const void* probe, const void* csq, const void* csum, void* out,
                             int64_t n, int d8, int d, int nq, float sqrt_d, int bm,
                             void* stream) {
  if (n <= 0 || nq <= 0) return 0;
  const EstimateArgs est{static_cast<const float*>(norms),  static_cast<const float*>(factors),
                         static_cast<const float*>(cdc),    static_cast<const int64_t*>(cluster),
                         static_cast<const uint8_t*>(probe), static_cast<const float*>(csq),
                         static_cast<const float*>(csum),   sqrt_d};
  return launch_batch<true>(static_cast<const uint8_t*>(codes), static_cast<const float*>(q),
                            static_cast<float*>(out), n, d8, d, nq, bm, est,
                            static_cast<cudaStream_t>(stream));
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
