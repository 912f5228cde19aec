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
// Design: one block of 8 warps takes one item at a time (a 1-D grid-stride
// loop over items, so M in the millions needs no second grid axis).  The
// block stages the item's query row in shared memory; each warp takes rows
// r, r + 8, ... of the tile; its lanes run along d, 16 bytes at a time when
// d % 4 == 0 and the codes base is 16-byte aligned, 4 otherwise (the
// "matrix" rotator leaves d = 100), and never read a query or code past d.
// A shuffle reduce gives g and lane 0 writes the fused epilogue.
//
// Bound: bytes.  Counting each input byte once, it must read the tiles its
// items name (tiles x tile x d x 4), their a, b, h, the item tables (16 B an
// item) and the probed query rows, and write M x tile x 4; it does
// 2 x M x tile x d FLOP, ~1/4 FLOP per byte of codes at most.  This kernel
// re-reads a tile once per item that names it, so at the plane's serving
// batch (1024 queries, nprobe 48: most tiles probed by several queries) it
// moves several times the bound.  The later lever is grouping items by tile
// so one tile load serves every query that probes it, as the host path
// ragged_topk_host groups its GEMMs by cluster (lakesoul_tpu/annplane/
// ragged.py:307-337); that is a redesign left to a later change.

#include "ls_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
ragged_score_kernel(const int* __restrict__ item_q, const int* __restrict__ item_tile,
                    const float* __restrict__ csq, const float* __restrict__ csum,
                    const float* __restrict__ q_glob, const float* __restrict__ codes,
                    const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ h, float* __restrict__ out, int64_t m, int d,
                    int tile) {
  extern __shared__ __align__(16) float q_sm[];  // d floats: this item's query row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t i = blockIdx.x; i < m; i += gridDim.x) {
    const float* qrow = q_glob + static_cast<int64_t>(item_q[i]) * d;
    __syncthreads();  // every warp is done with the previous item's row
    for (int k = threadIdx.x; k < d; k += kThreads) q_sm[k] = qrow[k];
    __syncthreads();
    const float c_sq = csq[i];
    const float c_sum = csum[i];
    const int64_t row0 = static_cast<int64_t>(item_tile[i]) * tile;
    float* o = out + i * tile;
    for (int r = warp; r < tile; r += kWarps) {
      const int64_t row = row0 + r;
      const float* c = codes + row * d;
      float g = 0.f;
      if constexpr (VEC) {
        for (int k = 4 * lane; k < d; k += 128) {
          const float4 x = *reinterpret_cast<const float4*>(c + k);
          const float4 y = *reinterpret_cast<const float4*>(q_sm + k);
          g = fmaf(x.x, y.x, g);
          g = fmaf(x.y, y.y, g);
          g = fmaf(x.z, y.z, g);
          g = fmaf(x.w, y.w, g);
        }
      } else {
        for (int k = lane; k < d; k += 32) g = fmaf(c[k], q_sm[k], g);
      }
      g = warp_sum(g);
      if (lane == 0) o[r] = b[row] + c_sq - h[row] * c_sum - a[row] * g;
    }
  }
}

template <bool VEC>
cudaError_t launch(const int* iq, const int* it, const float* csq, const float* csum,
                   const float* q, const float* codes, const float* a, const float* b,
                   const float* h, float* out, int64_t m, int d, int tile, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  const cudaError_t err = allow_smem(ragged_score_kernel<VEC>, smem);
  if (err != cudaSuccess) return err;
  ragged_score_kernel<VEC><<<grid_for(m, 1), kThreads, smem, s>>>(iq, it, csq, csum, q, codes, a,
                                                                  b, h, out, m, d, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// item_q, item_tile [m] int32; csq, csum [m] f32; q_glob [Q, d] f32;
// codes [R, d] f32; a, b, h [R] f32; out [m, tile] f32; all contiguous on the
// current device.  The caller has checked 0 <= item_q < Q and
// 0 <= item_tile < R / tile.  Returns a cudaError_t (0 = launched).
int ls_ragged_score(const void* item_q, const void* item_tile, const void* csq, const void* csum,
                    const void* q_glob, const void* codes, const void* a, const void* b,
                    const void* h, void* out, int64_t m, int d, int tile, void* stream) {
  if (m <= 0) return 0;
  const auto* iq = static_cast<const int*>(item_q);
  const auto* it = static_cast<const int*>(item_tile);
  const auto* cs = static_cast<const float*>(csq);
  const auto* cm = static_cast<const float*>(csum);
  const auto* q = static_cast<const float*>(q_glob);
  const auto* c = static_cast<const float*>(codes);
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(b);
  const auto* fh = static_cast<const float*>(h);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0)
    return launch<true>(iq, it, cs, cm, q, c, fa, fb, fh, o, m, d, tile, s);
  return launch<false>(iq, it, cs, cm, q, c, fa, fb, fh, o, m, d, tile, s);
}

}  // extern "C"
