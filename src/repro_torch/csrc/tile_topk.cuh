// Tile top-L of the PQ scan and merge kernels (pq_scan.cu, topk_merge.cu).
//
// The Pallas kernels keep each tile's top-L by L max/mask sweeps over a
// [Q, BN] score tile in VMEM, and merge the [Q, n_tiles * L] partials with
// lax.top_k outside the pallas_call.  Here each query's BN tile scores sit in
// shared memory as (value, row) pairs and a bitonic sort puts them in the
// order lax.top_k gives: value descending, row ascending among ties.  The
// first L of each run go out as that tile's candidates; a stable descending
// sort over the candidates (the wrapper's epilogue) then yields the global
// top-k with ties to the lower row, since tiles are laid out in row order.
//
// The sort costs BN * log2(BN)^2 / 4 compare-exchanges per query and tile
// whatever L < BN is; it is shared-memory bound and needs no data-dependent
// control flow.  When L = BN (k at least the tile width) every row is a
// candidate, so the kernels skip the sort and write the tile in row order:
// the stable merge alone then gives the same order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pandadb {

// Masked score: below every real score.  The reference's Pallas kernels pin
// padding and non-probed rows to the same value.
constexpr float NEG = -3.0e38f;

// True when (va, ia) goes before (vb, ib): larger value, then lower row.
__device__ __forceinline__ bool goes_first(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Sorts n_seg runs of seg_len (a power of two) pairs, laid out one after the
// other in v/r, each into goes_first order.  Every thread of the block must
// call it, after a __syncthreads() that publishes v/r; it ends synchronised.
__device__ void sort_runs(float* v, int* r, int n_seg, int seg_len) {
  const int half = seg_len >> 1;
  const int pairs = n_seg * half;
  for (int size = 2; size <= seg_len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int seg = p / half;
        const int j = p - seg * half;
        const int lo = 2 * stride * (j / stride) + (j % stride);
        const int a = seg * seg_len + lo;
        const int b = a + stride;
        const float va = v[a], vb = v[b];
        const int ia = r[a], ib = r[b];
        // runs whose `size` bit is clear end first-to-last; the others
        // last-to-first, so each pair of runs merges as a bitonic sequence
        const bool swap = ((lo & size) == 0) ? goes_first(vb, ib, va, ia)
                                             : goes_first(va, ia, vb, ib);
        if (swap) {
          v[a] = vb; v[b] = va;
          r[a] = ib; r[b] = ia;
        }
      }
      __syncthreads();
    }
  }
}

// Writes the first topl pairs of each of the n_seg sorted runs (query q0 + s)
// to cand_v/cand_i[q, tile * topl + l], rows of width n_tiles * topl.
__device__ void write_candidates(const float* v, const int* r, int n_seg,
                                 int seg_len, int topl, int q0, int tile,
                                 int n_tiles, float* cand_v, int* cand_i) {
  const size_t width = (size_t)n_tiles * topl;
  for (int e = threadIdx.x; e < n_seg * topl; e += blockDim.x) {
    const int s = e / topl;
    const int l = e - s * topl;
    const size_t o = (size_t)(q0 + s) * width + (size_t)tile * topl + l;
    cand_v[o] = v[s * seg_len + l];
    cand_i[o] = r[s * seg_len + l];
  }
}

}  // namespace pandadb
