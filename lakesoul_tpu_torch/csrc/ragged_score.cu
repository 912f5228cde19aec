// Ragged (query, cluster-tile) item scoring for the sharded ANN plane, for
// Hopper (sm_90a).  Built by lakesoul_tpu_torch/_build.py into a shared
// library with a plain C interface and bound through ctypes
// (lakesoul_tpu_torch/annplane/ragged.py).
//
// ls_ragged_score replaces lakesoul_tpu/annplane/ragged.py
//   ragged_score_pallas -> _ragged_score_pallas_call -> _ragged_score_kernel.
//   A work item i is one (query, tile) pair: item_q[i] names a row of q_glob
//   [Q, d], item_tile[i] a block of `tile` rows of the shard's codes [R, d]
//   (1-bit codes stored unpacked as f32, the resident layout).  For each row
//   of the tile:
//       out[i, r] = b[row] + csq[i] - h[row] * csum[i] - a[row] * g,
//       g = codes[row, :] . q_glob[item_q[i], :]
//   -> out [M, tile] f32.  Pad rows carry codes 0, a 0, b 1e30 and score
//   >= 1e29 (PAD_EST_VALID), which the top-k treats as holes.
//
// Bound: bytes.  Counting each input byte once, it must read the tiles its
// items name (tiles x tile x d x 4), their a, b, h, the item tables and the
// probed query rows, and write M x tile x 4; it does 2 x M x tile x d FLOP.
// At the plane's serving batch (1024 queries, nprobe 48) a probed tile is
// named by ~20 items, so the FLOP take ~0.05 ms on the f32 CUDA cores
// against ~0.13 ms for the bytes: the codes' bytes are what to save.  A
// kernel that reads a tile once per item moves ~17x the bound.
//
// Design: one tile load serves every item that names it.  The wrapper
// groups the items by tile on the device (group_items_by_tile: `order`
// lists item indices tile by tile, `tile_ptr` bounds each tile's run,
// `walk` lists the tiles by item count, largest first).  A persistent grid,
// two blocks a SM, walks `walk` with a grid stride, so the densest tiles --
// a query's nearest clusters are the dense ones -- start first and no block
// is left alone with one at the end; a block stops at the first tile with
// no items.  For its tile a block stages the rows' codes in shared memory
// with cp.async, 128 columns (64 KB) a slab, and the rows' a, b, h, then
// takes the tile's items in chunks of 32 queries, staging each chunk's
// query rows beside the codes.  While d fits one slab (the plane's d = 128)
// the codes are staged once per tile, so each probed tile is read from
// device memory once per launch; a wider d restages its slabs for each
// chunk of 32 items.  The other block on the SM computes while one stages.
// Warps split 2 ways along the rows (64 rows each: a lane owns rows r and
// r + 32) and 4 ways along the chunk's queries (group + 4 j): a 2 x 8
// register tile of f32 sums, each warp running only over the queries the
// chunk holds for it (a tile averages ~20), fed by conflict-free 16-byte
// shared loads (the row stride is 4 words past a multiple of 32).  The
// epilogue stores a warp's 32 lanes on 32 consecutive rows of one item:
// full 128-byte segments.
//
// Batch invariance: every (row, query) sum is one fmaf chain over k in
// ascending order, begun at 0 and taken by one thread, whatever the chunk,
// the tile-mates, the batch or the grid; pad columns of a ragged slab are
// zero.  So a query's scores are bitwise the same in any batch, which the
// plane's "alone = in a batch" checks rest on.

#include "ls_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 128;                             // rows a tile at most
constexpr int kRowBands = 2;                              // warps along the rows: 64 rows each
constexpr int kRowsPerLane = kMaxTile / (32 * kRowBands); // lane + 32 i of the band
constexpr int kQueryGroups = kWarps / kRowBands;          // warps along the queries
constexpr int kChunk = 32;                                // queries (items) a chunk
constexpr int kQueriesPerWarp = kChunk / kQueryGroups;    // group + 4 j
constexpr int kSlab = 128;                                // code columns staged at once

// Columns of one slab, padded to 4, and the shared row stride: a multiple of
// 32 words plus 4, so the 8 lanes of each quarter warp reading 16 bytes from
// 8 consecutive rows hit 32 distinct banks.
__host__ __device__ inline int slab_cols(int d) { return ((d < kSlab ? d : kSlab) + 3) / 4 * 4; }
__host__ __device__ inline int row_stride(int d) { return (slab_cols(d) + 31) / 32 * 32 + 4; }

inline size_t smem_bytes(int d) {
  return sizeof(float) * ((static_cast<size_t>(kMaxTile) + kChunk) * row_stride(d) +
                          3 * kMaxTile + 3 * kChunk);
}

// Stage `w` floats of one row (w4 = w rounded up to 4; zero past w).
template <bool VEC>
__device__ __forceinline__ void stage_row(float* dst, const float* src, int w, int w4, int lane) {
  if constexpr (VEC) {
    for (int c = 4 * lane; c < w; c += 128) cp_async16(dst + c, src + c, 16);
  } else {
    for (int c = lane; c < w4; c += 32) cp_async_elem<4>(dst + c, src + (c < w ? c : 0), c < w ? 4 : 0);
  }
}

// acc[i][j] += codes row (row + 32 i) . query row (group + 4 j) over the
// slab's w4 columns, for the warp's first NJ queries; k ascending.
template <int NJ>
__device__ __forceinline__ void slab_dot(float (&acc)[kRowsPerLane][kQueriesPerWarp],
                                         const float* c_s, const float* q_s, int stride, int w4,
                                         int row, int group) {
  const float* crow = c_s + row * stride;
  const float* qrow = q_s + group * stride;
#pragma unroll 4
  for (int k = 0; k < w4; k += 4) {
    float4 c[kRowsPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i)
      c[i] = *reinterpret_cast<const float4*>(crow + i * 32 * stride + k);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 q = *reinterpret_cast<const float4*>(qrow + j * kQueryGroups * stride + k);
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) {
        acc[i][j] = fmaf(c[i].x, q.x, acc[i][j]);
        acc[i][j] = fmaf(c[i].y, q.y, acc[i][j]);
        acc[i][j] = fmaf(c[i].z, q.z, acc[i][j]);
        acc[i][j] = fmaf(c[i].w, q.w, acc[i][j]);
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
ragged_score_kernel(const int* __restrict__ item_q, const float* __restrict__ csq,
                    const float* __restrict__ csum, const int64_t* __restrict__ order,
                    const int* __restrict__ tile_ptr, const int64_t* __restrict__ walk,
                    const float* __restrict__ q_glob, const float* __restrict__ codes,
                    const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ h, float* __restrict__ out, int n_tiles, int d,
                    int tile) {
  extern __shared__ __align__(16) float smem[];
  const int stride = row_stride(d);
  float* c_s = smem;                             // [kMaxTile][stride] code slab
  float* q_s = c_s + kMaxTile * stride;          // [kChunk][stride] query slab
  float* abh_s = q_s + kChunk * stride;          // a, b, h of the tile's rows
  float* csq_s = abh_s + 3 * kMaxTile;           // the chunk's csq, csum, items
  float* csum_s = csq_s + kChunk;
  int* item_s = reinterpret_cast<int*>(csum_s + kChunk);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = (warp % kRowBands) * 32 * kRowsPerLane + lane;  // rows row + 32 i
  const int group = warp / kRowBands;                              // queries group + 4 j
  const int n_slabs = (d + kSlab - 1) / kSlab;

  for (int64_t wi = blockIdx.x; wi < n_tiles; wi += gridDim.x) {
    const int64_t t = walk[wi];
    const int p0 = tile_ptr[t];
    const int n = tile_ptr[t + 1] - p0;
    if (n == 0) break;  // the walk is in falling item count: no work is left
    const int64_t row0 = t * tile;
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      const int nc = min(kChunk, n - c0);
      const int nj =
          nc > group ? min(kQueriesPerWarp, (nc - group + kQueryGroups - 1) / kQueryGroups) : 0;
      float acc[kRowsPerLane][kQueriesPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i)
#pragma unroll
        for (int j = 0; j < kQueriesPerWarp; ++j) acc[i][j] = 0.f;

      for (int s = 0; s < n_slabs; ++s) {
        const int k0 = s * kSlab;
        const int w = min(kSlab, d - k0);
        const int w4 = (w + 3) / 4 * 4;
        __syncthreads();  // every thread is done with the shared buffers
        if (c0 == 0 && s == 0) {
          for (int r = threadIdx.x; r < tile; r += kThreads) {
            cp_async_elem<4>(abh_s + r, a + row0 + r, 4);
            cp_async_elem<4>(abh_s + kMaxTile + r, b + row0 + r, 4);
            cp_async_elem<4>(abh_s + 2 * kMaxTile + r, h + row0 + r, 4);
          }
        }
        if (c0 == 0 || n_slabs > 1) {
          for (int r = warp; r < tile; r += kWarps)
            stage_row<VEC>(c_s + r * stride, codes + (row0 + r) * d + k0, w, w4, lane);
        }
        // this warp stages query rows warp + 8 j: lane j fetches row j's
        // query index (the loads in parallel), then the warp copies each row
        const int jl = warp + kWarps * lane;
        const int my_q = lane < kChunk / kWarps && jl < nc ? item_q[order[p0 + c0 + jl]] : 0;
#pragma unroll
        for (int j = 0; j < kChunk / kWarps; ++j) {
          const int qi = __shfl_sync(0xffffffffu, my_q, j);
          if (warp + kWarps * j < nc)
            stage_row<VEC>(q_s + (warp + kWarps * j) * stride,
                           q_glob + static_cast<int64_t>(qi) * d + k0, w, w4, lane);
        }
        if (s == 0 && threadIdx.x < nc) {
          const int64_t item = order[p0 + c0 + threadIdx.x];
          item_s[threadIdx.x] = static_cast<int>(item);
          csq_s[threadIdx.x] = csq[item];
          csum_s[threadIdx.x] = csum[item];
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        switch (nj) {
          case 8: slab_dot<8>(acc, c_s, q_s, stride, w4, row, group); break;
          case 7: slab_dot<7>(acc, c_s, q_s, stride, w4, row, group); break;
          case 6: slab_dot<6>(acc, c_s, q_s, stride, w4, row, group); break;
          case 5: slab_dot<5>(acc, c_s, q_s, stride, w4, row, group); break;
          case 4: slab_dot<4>(acc, c_s, q_s, stride, w4, row, group); break;
          case 3: slab_dot<3>(acc, c_s, q_s, stride, w4, row, group); break;
          case 2: slab_dot<2>(acc, c_s, q_s, stride, w4, row, group); break;
          case 1: slab_dot<1>(acc, c_s, q_s, stride, w4, row, group); break;
          default: break;
        }
      }

      // epilogue: the warp's lanes on consecutive rows of one item
#pragma unroll
      for (int j = 0; j < kQueriesPerWarp; ++j) {
        if (j >= nj) break;
        const int q = group + j * kQueryGroups;
        const float c_sq = csq_s[q];
        const float c_sum = csum_s[q];
        float* o = out + static_cast<int64_t>(item_s[q]) * tile;
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i) {
          const int r = row + 32 * i;
          if (r < tile)
            o[r] = abh_s[kMaxTile + r] + c_sq - abh_s[2 * kMaxTile + r] * c_sum -
                   abh_s[r] * acc[i][j];
        }
      }
    }
  }
}

template <bool VEC>
cudaError_t launch(const int* iq, const float* csq, const float* csum, const int64_t* order,
                   const int* tile_ptr, const int64_t* walk, const float* q, const float* codes,
                   const float* a, const float* b, const float* h, float* out, int64_t m,
                   int n_tiles, int d, int tile, cudaStream_t s) {
  const size_t smem = smem_bytes(d);
  const auto kernel = ragged_score_kernel<VEC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 132;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // one wave of resident blocks, never more than the tiles that can have items
  const int64_t probed = m < n_tiles ? m : n_tiles;
  const int64_t wave = static_cast<int64_t>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(probed < wave ? probed : wave);
  kernel<<<grid, kThreads, smem, s>>>(iq, csq, csum, order, tile_ptr, walk, q, codes, a, b, h,
                                      out, n_tiles, d, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// item_q [m] int32; csq, csum [m] f32; order [m] int64, tile_ptr
// [n_tiles + 1] int32 and walk [n_tiles] int64 from group_items_by_tile;
// q_glob [Q, d] f32; codes [n_tiles * tile, d] f32; a, b, h [n_tiles * tile]
// f32; out [m, tile] f32; all contiguous on the current device.  The caller
// has checked 0 <= item_q < Q, 0 <= item_tile < n_tiles and m < 2^31.
// 1 <= tile <= 128.  Returns a cudaError_t (0 = launched).
int ls_ragged_score(const void* item_q, const void* csq, const void* csum, const void* order,
                    const void* tile_ptr, const void* walk, const void* q_glob, const void* codes,
                    const void* a, const void* b, const void* h, void* out, int64_t m,
                    int n_tiles, int d, int tile, void* stream) {
  if (tile < 1 || tile > kMaxTile || d < 1) return cudaErrorInvalidValue;
  if (m <= 0 || n_tiles <= 0) return 0;
  const auto* iq = static_cast<const int*>(item_q);
  const auto* cs = static_cast<const float*>(csq);
  const auto* cm = static_cast<const float*>(csum);
  const auto* od = static_cast<const int64_t*>(order);
  const auto* tp = static_cast<const int*>(tile_ptr);
  const auto* wk = static_cast<const int64_t*>(walk);
  const auto* q = static_cast<const float*>(q_glob);
  const auto* c = static_cast<const float*>(codes);
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(b);
  const auto* fh = static_cast<const float*>(h);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(q_glob) % 16 == 0)
    return launch<true>(iq, cs, cm, od, tp, wk, q, c, fa, fb, fh, o, m, n_tiles, d, tile, s);
  return launch<false>(iq, cs, cm, od, tp, wk, q, c, fa, fb, fh, o, m, n_tiles, d, tile, s);
}

}  // extern "C"
