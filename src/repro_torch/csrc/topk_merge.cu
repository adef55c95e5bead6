// topk_merge: k-way merge of per-shard top-k windows for Hopper.
//
// Replaces the Pallas kernel merge_topk_pallas (body _merge_kernel) of
// src/repro/kernels/topk_merge/topk_merge.py.  Input: P shard windows
// vals [P, Q, K] f32, each row already sorted by its shard.  Candidate column
// c = p * K + j of query q is vals[p, q, j]; the windows are read in place, so
// the reference's transpose-and-reshape copy to [Q, P * K] never happens.
//
// Each value is clamped up to CLAMP, so a (-inf, -1) padding column (a shard
// with fewer than K real rows, or a dropped shard) becomes a CLAMP tie that is
// taken exactly once, lower column first, as lax.top_k orders the raw -inf.
// Columns >= n_valid are pinned to NEG, strictly below CLAMP, and the caller
// keeps k <= n_valid, so they are never chosen.  Output: the top k (value,
// column) pairs per query in lax.top_k order (value desc, column asc).  The
// wrapper gathers the int64 id payloads by column and restores -inf where
// value <= CLAMP.
//
// Two steps, both on the card:
// 1. merge_tile_topk: per tile of SEG columns, a bitonic sort in shared
//    memory (the scan kernels' tile_topk.cuh) keeps the tile's first
//    L = min(k, SEG) pairs as a sorted run.  SEG is the smallest power of two
//    >= C up to 256, so a short window (C = P * k of a few dozen) sorts a
//    short run; when C <= SEG the one run is the answer.
// 2. merge_run_pairs, while more than one run is left: runs 2r and 2r + 1
//    merge into one run of min(2L, k) pairs.  Each pair finds its rank in the
//    merged run by a binary search in the other run (ties to the earlier run,
//    which holds the lower columns), so every thread writes one output slot
//    and no thread waits on another.  ceil(log2(tiles)) passes.
//
// Bound: the merge does no arithmetic, so it is bound by bytes: Q * C values
// read (ids are read only for the k chosen columns, by the wrapper).
#include <algorithm>

#include "tile_topk.cuh"

namespace {

using pandadb::NEG;

constexpr float CLAMP = -1.0e38f;  // input floor: above NEG, below any score
constexpr int THREADS = 256;
constexpr int ELEMS = 2048;        // (value, column) pairs staged per block
constexpr int MAX_SEG = 256;       // widest tile
constexpr int MAX_GRID_Y = 65535;
constexpr int PAD_COL = 0x7fffffff;  // column of the pairs that fill a lone run

__global__ void __launch_bounds__(THREADS)
merge_tile_topk(const float* __restrict__ vals, float* __restrict__ cand_v,
                int* __restrict__ cand_i, int n_q, int n_q_all, int q_base,
                int kk, int n_valid, int seg, int topl) {
  __shared__ float sv[ELEMS];
  __shared__ int si[ELEMS];

  const int qb = ELEMS / seg;
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * qb;
  const int n_seg = min(qb, n_q - q0);
  const int col0 = tile * seg;

  for (int e = threadIdx.x; e < n_seg * seg; e += THREADS) {
    const int s = e / seg;
    const int col = col0 + (e - s * seg);
    float v = NEG;
    if (col < n_valid) {
      const int p = col / kk;
      const int j = col - p * kk;
      const size_t q = (size_t)q_base + q0 + s;
      v = fmaxf(vals[((size_t)p * n_q_all + q) * kk + j], CLAMP);
    }
    sv[e] = v;
    si[e] = col;
  }
  __syncthreads();
  pandadb::sort_runs(sv, si, n_seg, seg);
  pandadb::write_candidates(sv, si, n_seg, seg, topl, q0, tile, gridDim.x,
                            cand_v, cand_i);
}

// in: n_in sorted runs of len_in pairs per query (rows of n_in * len_in);
// out: ceil(n_in / 2) sorted runs of len_out = min(2 * len_in, k) pairs.  A
// run without a partner is copied and its slot filled with (NEG, PAD_COL).
// Grid: x over a row's ceil(n_in / 2) * 2 * len_in inputs, y over queries.
__global__ void __launch_bounds__(THREADS)
merge_run_pairs(const float* __restrict__ in_v, const int* __restrict__ in_i,
                float* __restrict__ out_v, int* __restrict__ out_i, int q_base,
                int n_in, int len_in, int len_out) {
  const int n_out = (n_in + 1) / 2;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= n_out * 2 * len_in) return;
  const size_t q = (size_t)q_base + blockIdx.y;
  const int pair = e / (2 * len_in);
  const int f = e - pair * 2 * len_in;
  const int side = f / len_in;              // 0: run 2 * pair, 1: its partner
  const int i = f - side * len_in;
  const int run = 2 * pair + side;
  const size_t row_in = q * n_in * len_in;
  const size_t slot = (q * n_out + pair) * len_out;
  if (run >= n_in) {                        // no partner: fill the slot's tail
    if (len_in + i < len_out) {
      out_v[slot + len_in + i] = NEG;
      out_i[slot + len_in + i] = PAD_COL;
    }
    return;
  }
  if (i >= len_out) return;                 // its rank is at least i
  const float v = in_v[row_in + (size_t)run * len_in + i];
  const int c = in_i[row_in + (size_t)run * len_in + i];
  int rank = i;
  const int other = run ^ 1;
  if (other < n_in) {
    const float* bv = in_v + row_in + (size_t)other * len_in;
    const int* bi = in_i + row_in + (size_t)other * len_in;
    // pairs of the other run that go before (v, c); the earlier run wins
    // ties, so the merged run is stable.  The column is read only on a tie.
    int lo = 0, hi = len_in;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const float w = bv[mid];
      const bool before =
          w > v || (w == v && (side == 0 ? bi[mid] < c : bi[mid] <= c));
      if (before) lo = mid + 1; else hi = mid;
    }
    rank += lo;
  }
  if (rank < len_out) {
    out_v[slot + rank] = v;
    out_i[slot + rank] = c;
  }
}

int tile_cols(int n_cols) {
  int seg = 32;
  while (seg < n_cols && seg < MAX_SEG) seg <<= 1;
  return seg;
}

}  // namespace

// Pairs per query row that each of the two work buffers of topk_merge must
// hold: the widest row of runs any step writes there, 0 for one tile.
extern "C" int topk_merge_work_cols(int n_cols, int k) {
  const int seg = tile_cols(n_cols);
  int n_runs = (n_cols + seg - 1) / seg;
  int len = std::min(k, seg);
  long long widest = 0;
  while (n_runs > 1) {
    widest = std::max(widest, (long long)n_runs * len);
    n_runs = (n_runs + 1) / 2;
    len = std::min(2 * len, k);
  }
  return (int)widest;
}

// vals [P, n_q, kk] f32 (contiguous) -> out_v f32 / out_c int32 columns
// [n_q, k], k in [1, n_valid], n_valid in [1, P * kk].  work_v / work_c hold
// 2 * n_q * topk_merge_work_cols(P * kk, k) pairs (none for one tile).
// Returns cudaError_t.
extern "C" int topk_merge(const float* vals, float* out_v, int* out_c,
                          float* work_v, int* work_c, int n_p, int n_q, int kk,
                          int n_valid, int k, void* stream) {
  if (n_q <= 0 || n_p <= 0 || kk <= 0) return 0;
  const int n_cols = n_p * kk;
  if (k < 1 || k > n_valid || n_valid > n_cols)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int seg = tile_cols(n_cols);
  const int n_tiles = (n_cols + seg - 1) / seg;
  const int topl = std::min(k, seg);
  const size_t half = (size_t)n_q * topk_merge_work_cols(n_cols, k);
  float* run_v = n_tiles == 1 ? out_v : work_v;
  int* run_c = n_tiles == 1 ? out_c : work_c;

  const size_t width = (size_t)n_tiles * topl;
  const int qb = ELEMS / seg;
  const int q_step = MAX_GRID_Y * qb;
  for (int qa = 0; qa < n_q; qa += q_step) {
    const int nq = std::min(q_step, n_q - qa);
    dim3 grid(n_tiles, (nq + qb - 1) / qb);
    merge_tile_topk<<<grid, THREADS, 0, st>>>(
        vals, run_v + (size_t)qa * width, run_c + (size_t)qa * width, nq, n_q,
        qa, kk, n_valid, seg, topl);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  int n_runs = n_tiles, len = topl, which = 0;
  while (n_runs > 1) {
    const int n_out = (n_runs + 1) / 2;
    const int len_out = std::min(2 * len, k);
    float* dst_v = work_v + (which ^ 1) * half;
    int* dst_c = work_c + (which ^ 1) * half;
    if (n_out == 1) {                       // the last step writes the answer
      if (len_out != k) return (int)cudaErrorInvalidValue;
      dst_v = out_v;
      dst_c = out_c;
    }
    const int per_q = n_out * 2 * len;
    for (int qa = 0; qa < n_q; qa += MAX_GRID_Y) {
      dim3 grid((per_q + THREADS - 1) / THREADS,
                std::min(MAX_GRID_Y, n_q - qa));
      merge_run_pairs<<<grid, THREADS, 0, st>>>(
          work_v + which * half, work_c + which * half, dst_v, dst_c, qa,
          n_runs, len, len_out);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    n_runs = n_out;
    len = len_out;
    which ^= 1;
  }
  return 0;
}
