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
// ls_packed_dot and ls_packed_estimate are the two modes of one kernel,
// which replaces lakesoul_tpu/vector/kernels.py
//   packed_dot_pallas -> _packed_dot_kernel
// and, in its second mode, also the jnp estimator and probe mask the
// reference wraps around that call (_fused_search_resident, kernels.py:
// 268-277), which the resident single query runs.
//   Product mode: bits [N, 8*d8] x q[d] -> [N] f32.  At N = 1,048,576,
//   d = 512 it moves 71 MB (~21 us at 3.35 TB/s) for 5.4e8 FLOP: bound by
//   bytes.  A multiply-add a bit (shift, shift, and, fma) is ~2,000
//   instructions a row, ~2e9 in all, ~70 us at the card's ~3e13 thread
//   instructions a second: the old one-thread-a-row loop was bound by
//   instructions, not bytes.  Design: nibble lookup tables.  For each 4
//   dimensions 4k .. 4k+3 a 16-entry table T_k[v] holds the sum of the
//   query over the bits of v (MSB first, as the packing: a byte's high
//   nibble is table 2p, its low nibble 2p + 1); 2 * d8 tables, 8 KB at
//   d = 512, built once a persistent block from the query copied to shared
//   memory.  A row is then 2 * d8 lookups and adds (a byte permute, an
//   address add, a shared load and an add each): ~4x fewer instructions,
//   and the pace is set by shared loads, one warp-wide load a cycle an SM:
//   1,048,576 x 128 lookups in ~18 us, under the bytes.  All lanes of a
//   warp read the same table at once (one row a thread, the same loop), so
//   a load touches 16 consecutive banks whatever the nibbles: no bank
//   conflicts.  Code rows reach shared memory by coalesced copies
//   (cp.async of 16 bytes, neighbouring threads on neighbouring words; 4 or
//   1 bytes where base or stride is not 16-byte aligned), each row at an odd
//   multiple of 16 bytes, so a thread's 16-byte reads of its row do not
//   conflict either.
//   Estimate mode: the same sum, then rabitq_estimate (shared with the
//   batch kernel's epilogue) with the per-row norm, factor and code_dot_c
//   and the row's cluster's csq and csum, +inf where the cluster is not
//   probed.  A row whose cluster is not probed reads neither code bytes nor
//   per-row floats, only its cluster id; rows are sorted by cluster, so most
//   tiles are skipped whole.  Bound by bytes: 8 N of cluster ids, the
//   probed share of N * (d8 + 12), 4 N of output (~15 MB, ~4.5 us, at the
//   slice's 32 of 1024 clusters).
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

// The estimator's per-row and per-(cluster, query) tables, nq = 1 for
// packed_dot's estimate mode; unused in product mode.
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

// The RaBitQ estimate in the global query frame, _estimate
// (vector/kernels.py) operation for operation, in round-to-nearest
// intrinsics that the compiler cannot contract to FMAs: one function for
// the batch kernel's epilogue and packed_dot's estimate mode, so a query
// gets the same rounding alone and in a batch.
__device__ __forceinline__ float rabitq_estimate(float bq, float nrm, float fac, float cdc,
                                                 float csq, float csum, float sqrt_d) {
  const float dot = __fdiv_rn(__fsub_rn(__fmul_rn(2.f, __fsub_rn(cdc, bq)), csum), sqrt_d);
  return __fadd_rn(__fadd_rn(__fmul_rn(nrm, nrm), csq),
                   __fdiv_rn(__fmul_rn(__fmul_rn(2.f, nrm), dot), fac));
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
                // the estimate only where the cluster is probed: +inf elsewhere
                const int64_t at = cl[e] * nq + qi;
                v[e] = __int_as_float(0x7f800000);
                if (__ldg(probe + at))
                  v[e] = rabitq_estimate(acc[i][j][hh * 2 + e], nrm[e], fac[e], cdc[e],
                                         __ldg(csq + at), __ldg(csum + at), est.sqrt_d);
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
// packed_dot / packed_estimate: nibble lookup tables
// ---------------------------------------------------------------------------

constexpr int kLutMaxRows = 256;  // rows a tile at most: one a thread

// 16-byte words of a row, rounded up; the tables cover them all (32 a word)
__host__ __device__ constexpr int lut_words(int d8) { return (d8 + 15) / 16; }
// a staged row's stride in shared memory: an odd number of 16-byte words,
// so the 8 rows a quarter-warp reads with 16-byte loads fall in 8 bank groups
__host__ __device__ constexpr int lut_row_stride(int d8) { return (lut_words(d8) | 1) * 16; }
// shared memory of a block: the tables [32 * words][16] f32, the query
// [128 * words] f32, the tile's rows and, in estimate mode, a probe flag a
// row
__host__ __device__ constexpr size_t lut_smem(int d8, int rows) {
  return static_cast<size_t>(lut_words(d8)) * (32 * 16 + 128) * 4 +
         static_cast<size_t>(rows) * (lut_row_stride(d8) + 1);
}

// The entry of table `t` at byte offset `off` (4 x the nibble)
__device__ __forceinline__ float lut_at(const float* t, uint32_t off) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(t) + off);
}

// packed_dot in two modes.  A persistent block copies the query to shared
// memory (zero past d) and builds from it the 2 * 16 * words nibble tables
// once (T_k[v] = sum of q[4k + j] over the bits j of v, MSB first, j
// ascending), then walks tiles of blockDim.x rows: it stages the tile's
// rows in shared memory with coalesced copies of W bytes (16, 4 or 1, as
// base and stride allow), and each thread sums its row's 2 * d8 lookups.
// A warp's lanes look up the same table at once, so they read 16
// consecutive banks whatever their nibbles.  ESTIMATE: a tile none of
// whose rows' clusters is probed reads no code byte; in the others only
// probed rows are staged and scored, the rest are +inf.
template <int W, bool ESTIMATE>
__global__ void __launch_bounds__(kLutMaxRows)
packed_dot_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ q,
                  float* __restrict__ out, int64_t n, int d8, int d, EstimateArgs est) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = lut_words(d8), rs = lut_row_stride(d8);
  const int rows_per_tile = blockDim.x, tid = threadIdx.x;
  float* lut = reinterpret_cast<float*>(smem);                            // [32 * words][16]
  float* q_s = lut + words * 32 * 16;                                     // [128 * words]
  uint8_t* rows_s = reinterpret_cast<uint8_t*>(q_s + words * 128);        // [rows][rs]
  uint8_t* flag_s = rows_s + static_cast<size_t>(rows_per_tile) * rs;     // [rows]

  for (int k = tid; k < words * 128; k += rows_per_tile) q_s[k] = k < d ? q[k] : 0.f;
  __syncthreads();
  for (int e = tid; e < words * 32 * 16; e += rows_per_tile) {
    const int k = e >> 4, v = e & 15;
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((v >> (3 - j)) & 1) t += q_s[4 * k + j];
    lut[e] = t;
  }
  // (the first tile's barriers order these stores before any lookup)

  const float inf = __int_as_float(0x7f800000);
  const int64_t tiles = (n + rows_per_tile - 1) / rows_per_tile;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * rows_per_tile, row = row0 + tid;
    const int rows = static_cast<int>(n - row0 < rows_per_tile ? n - row0 : rows_per_tile);
    bool live = row < n;  // this thread's row is scored
    int64_t cl = 0;
    if constexpr (ESTIMATE) {
      if (live) {
        cl = est.cluster[row];
        live = est.probe[cl] != 0;
      }
      flag_s[tid] = live;
      if (!__syncthreads_or(live)) {  // no row of the tile probed
        if (row < n) out[row] = inf;
        continue;
      }
    }

    // stage the rows (estimate mode: the probed ones), neighbouring threads
    // on neighbouring bytes; bytes past d8 stay unset: they index the zero
    // tables past 2 * d8
    const uint8_t* src = codes + row0 * d8;
    if constexpr (W == 16) {
      for (int u = tid; u < rows * words; u += rows_per_tile) {
        const int r = u / words, w = u - r * words;
        if (!ESTIMATE || flag_s[r]) cp_async16(rows_s + r * rs + 16 * w, src + 16 * u, 16);
      }
    } else if constexpr (W == 4) {
      const int per_row = d8 / 4;
      for (int u = tid; u < rows * per_row; u += rows_per_tile) {
        const int r = u / per_row, w = u - r * per_row;
        if (!ESTIMATE || flag_s[r]) cp_async_elem<4>(rows_s + r * rs + 4 * w, src + 4 * u, 4);
      }
    } else {
      for (int u = tid; u < rows * d8; u += rows_per_tile) {
        const int r = u / d8, b = u - r * d8;
        if (!ESTIMATE || flag_s[r]) rows_s[r * rs + b] = src[u];
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    if (live) {
      // four sums: byte parity x nibble; bytes ascending in each
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const uint8_t* mine = rows_s + tid * rs;
      for (int w = 0; w < words; ++w) {
        const uint4 v = *reinterpret_cast<const uint4*>(mine + 16 * w);
        const uint32_t x[4] = {v.x, v.y, v.z, v.w};
        const float* tw = lut + w * 32 * 16;  // the 32 tables of this word's 16 bytes
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t hi = (x[i] >> 2) & 0x3C3C3C3Cu;  // 4 x each byte's high nibble
          const uint32_t lo = (x[i] << 2) & 0x3C3C3C3Cu;  // 4 x each byte's low nibble
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float* tb = tw + 32 * (4 * i + j);  // byte 4i + j: tables 2b, 2b + 1
            acc[2 * (j & 1)] += lut_at(tb, __byte_perm(hi, 0, 0x4440u | j));
            acc[2 * (j & 1) + 1] += lut_at(tb + 16, __byte_perm(lo, 0, 0x4440u | j));
          }
        }
      }
      const float bq = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      if constexpr (ESTIMATE)
        out[row] = rabitq_estimate(bq, est.norms[row], est.factors[row], est.cdc[row],
                                   est.csq[cl], est.csum[cl], est.sqrt_d);
      else
        out[row] = bq;
    } else if (ESTIMATE && row < n) {
      out[row] = inf;
    }
    __syncthreads();  // the next tile restages the rows
  }
}

// ---------------------------------------------------------------------------
// packed_scan: CUDA-core row loop
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

// One resident wave of persistent blocks of 256 rows a tile, or of 128, 64
// or 32 where a wide query's tables leave too little shared memory.
template <int W, bool ESTIMATE>
cudaError_t launch_lut(const uint8_t* codes, const float* q, float* out, int64_t n, int d8,
                       int d, const EstimateArgs& est, cudaStream_t stream) {
  int dev = 0, limit = 232448;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int rows = kLutMaxRows;
  while (rows > 32 && lut_smem(d8, rows) > static_cast<size_t>(limit)) rows /= 2;
  const size_t smem = lut_smem(d8, rows);
  const auto kernel = packed_dot_kernel<W, ESTIMATE>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, rows, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  kernel<<<grid_for(n, rows, per_sm), rows, smem, stream>>>(codes, q, out, n, d8, d, est);
  return cudaGetLastError();
}

// W by what the codes' base and row stride allow
template <bool ESTIMATE>
cudaError_t launch_packed_dot(const void* codes, const void* q, void* out, int64_t n, int d8,
                              int d, const EstimateArgs& est, void* stream) {
  if (n <= 0) return cudaSuccess;
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* qf = static_cast<const float*>(q);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const auto addr = reinterpret_cast<uintptr_t>(codes);
  if (d8 % 16 == 0 && addr % 16 == 0) return launch_lut<16, ESTIMATE>(c, qf, o, n, d8, d, est, s);
  if (d8 % 4 == 0 && addr % 4 == 0) return launch_lut<4, ESTIMATE>(c, qf, o, n, d8, d, est, s);
  return launch_lut<1, ESTIMATE>(c, qf, o, n, d8, d, est, s);
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
  return launch_packed_dot<false>(codes, q, out, n, d8, d, EstimateArgs{}, stream);
}

// Estimate mode.  As ls_packed_dot, plus norms, factors, code_dot_c [n] f32
// and cluster [n] int64 (each in [0, nlist)), probe [nlist] bool, csq and
// csum [nlist] f32; out [n] f32, +inf where the row's cluster is not
// probed.  sqrt_d is sqrt(d) rounded to f32.  Returns a cudaError_t.
int ls_packed_estimate(const void* codes, const void* q, const void* norms, const void* factors,
                       const void* cdc, const void* cluster, const void* probe, const void* csq,
                       const void* csum, void* out, int64_t n, int d8, int d, float sqrt_d,
                       void* stream) {
  const EstimateArgs est{static_cast<const float*>(norms),  static_cast<const float*>(factors),
                         static_cast<const float*>(cdc),    static_cast<const int64_t*>(cluster),
                         static_cast<const uint8_t*>(probe), static_cast<const float*>(csq),
                         static_cast<const float*>(csum),   sqrt_d};
  return launch_packed_dot<true>(codes, q, out, n, d8, d, est, stream);
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
