// topk_merge: k-way merge of per-shard top-k windows for Hopper.
//
// Replaces the Pallas kernel merge_topk_pallas (body _merge_kernel) of
// src/repro/kernels/topk_merge/topk_merge.py.  Input: P shard windows
// vals [P, Q, K] f32 and their id payloads ids [P, Q, K] (int64 or int32).
// Candidate column c = p * K + j of query q is vals[p, q, j]; the windows
// are read in place, so the reference's transpose-and-reshape copy to
// [Q, P * K] never happens.  Nothing assumes a window is sorted.
//
// Each value is clamped up to CLAMP, so a (-inf, -1) padding column (a shard
// with fewer than K real rows, or a dropped shard) becomes a CLAMP tie that is
// taken exactly once, lower column first, as lax.top_k orders the raw -inf.
// Columns >= n_valid are never chosen (the caller keeps k <= n_valid).
// Output: the top k values per query in lax.top_k order (value desc,
// column asc), -inf restored where the value is <= CLAMP, and the ids of
// their columns, copied as raw bits from the windows.
//
// Two paths, by the window width C = P * K:
// - C <= SMALL_COLS: merge_small, one launch (the cluster kNN's merges:
//   P = 4 shards of k = 10 or 100).  A block stages the clamped columns of ELEMS / SEG
//   queries as (value, column) pairs in shared memory, SEG the smallest
//   power of two >= C, pins the pairs past n_valid to NEG, sorts each
//   query's run by a bitonic sort (value desc, column asc) and writes the
//   first k values and their ids.
// - C > SMALL_COLS (large k): radix_select.cuh's selection over the clamped
//   columns (MergeWindows reads them in place), one block per query, leaves
//   the k survivors in column order; the wrapper's stable sort over [Q, k]
//   orders them, and merge_epilogue restores -inf and gathers the ids.
//
// Bound: the merge does no arithmetic, so it is bound by bytes: Q * C values
// read, ids read and (value, id) written for the k chosen columns only.
#include "radix_select.cuh"

namespace {

using pandadb::NEG;
using pandadb::PER;

constexpr float CLAMP = -1.0e38f;  // input floor: above NEG, below any score
constexpr int THREADS = 256;
constexpr int ELEMS = 2048;        // (value, column) pairs staged per block
constexpr int SMALL_COLS = 512;    // widest window of the one-launch path

// True when (va, ia) goes before (vb, ib): larger value, then lower column.
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

// out_v[o] = v with -inf restored; out_ids[o] = the id of column col of
// query q, copied as id_bytes (4 or 8) raw bytes
__device__ __forceinline__ void emit(float v, int col, size_t q, size_t o,
                                     const void* ids, void* out_ids, int n_q,
                                     int kk, int id_bytes, float* out_v) {
  out_v[o] = v <= CLAMP ? __int_as_float(0xff800000) : v;   // -inf
  const int p = col / kk;
  const size_t src = ((size_t)p * n_q + q) * kk + (col - p * kk);
  if (id_bytes == 8)
    static_cast<unsigned long long*>(out_ids)[o] =
        static_cast<const unsigned long long*>(ids)[src];
  else
    static_cast<unsigned*>(out_ids)[o] =
        static_cast<const unsigned*>(ids)[src];
}

// Block b: queries b * (ELEMS / seg) .., each a run of seg >= C pairs.
__global__ void __launch_bounds__(THREADS)
merge_small(const float* __restrict__ vals, const void* __restrict__ ids,
            float* __restrict__ out_v, void* __restrict__ out_ids, int n_q,
            int kk, int n_valid, int k, int seg, int id_bytes) {
  __shared__ float sv[ELEMS];
  __shared__ int si[ELEMS];
  const int qb = ELEMS / seg;
  const int q0 = blockIdx.x * qb;
  const int n_seg = min(qb, n_q - q0);
  for (int e = threadIdx.x; e < n_seg * seg; e += THREADS) {
    const int s = e / seg;
    const int col = e - s * seg;
    float v = NEG;
    if (col < n_valid) {
      const int p = col / kk;
      const size_t q = (size_t)q0 + s;
      v = fmaxf(vals[((size_t)p * n_q + q) * kk + (col - p * kk)], CLAMP);
    }
    sv[e] = v;
    si[e] = col;
  }
  __syncthreads();
  sort_runs(sv, si, n_seg, seg);
  for (int e = threadIdx.x; e < n_seg * k; e += THREADS) {
    const int s = e / k;
    const int l = e - s * k;
    const size_t q = (size_t)q0 + s;
    emit(sv[s * seg + l], si[s * seg + l], q, q * k + l, ids, out_ids, n_q,
         kk, id_bytes, out_v);
  }
}

// The selection's view of query q's C columns: column c = p * K + j is
// window p's value j, clamped up to CLAMP.
struct MergeWindows {
  const float* vals;
  int n_q, kk, n_valid;

  struct Row {
    const float* v;      // window 0 of the query
    size_t stride;       // from one window to the next
    int kk, n, col0;
    __device__ __forceinline__ void load(int i0, int n, float (&x)[PER]) const {
      int p = i0 / kk;
      int j = i0 - p * kk;
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        x[u] = i0 + u < n ? fmaxf(v[p * stride + j], CLAMP) : NEG;
        if (++j == kk) {
          j = 0;
          ++p;
        }
      }
    }
  };

  __device__ __forceinline__ Row row(int q) const {
    return Row{vals + (size_t)q * kk, (size_t)n_q * kk, kk, n_valid, 0};
  }
};

// v / pos [n_q, k]: the survivors' values sorted (stable, descending) and
// the sort's permutation; cols [n_q, k] the survivors' columns.  Restores
// -inf in v in place and writes the ids.
__global__ void __launch_bounds__(THREADS)
merge_epilogue(float* __restrict__ v, const long long* __restrict__ pos,
               const int* __restrict__ cols, const void* __restrict__ ids,
               void* __restrict__ out_ids, int n_q, int kk, int k,
               int id_bytes) {
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (size_t)n_q * k) return;
  const size_t q = e / k;
  emit(v[e], cols[q * k + pos[e]], q, e, ids, out_ids, n_q, kk, id_bytes, v);
}

bool bad_args(int n_p, int kk, int n_valid, int k, int id_bytes) {
  return k < 1 || k > n_valid || n_valid > n_p * kk ||
         (id_bytes != 4 && id_bytes != 8);
}

}  // namespace

// vals [P, n_q, kk] f32 and ids [P, n_q, kk] (id_bytes 4 or 8 a value),
// both contiguous, P * kk <= SMALL_COLS -> out_v f32 / out_ids [n_q, k],
// the top k of each query's first n_valid columns in lax.top_k order, -inf
// restored.  1 <= k <= n_valid <= P * kk.  Returns cudaError_t.
extern "C" int topk_merge_small(const float* vals, const void* ids,
                                int id_bytes, float* out_v, void* out_ids,
                                int n_p, int n_q, int kk, int n_valid, int k,
                                void* stream) {
  if (n_q <= 0 || n_p <= 0 || kk <= 0) return 0;
  const int n_cols = n_p * kk;
  if (bad_args(n_p, kk, n_valid, k, id_bytes) || n_cols > SMALL_COLS)
    return (int)cudaErrorInvalidValue;
  int seg = 32;
  while (seg < n_cols) seg <<= 1;
  const int qb = ELEMS / seg;
  merge_small<<<(n_q + qb - 1) / qb, THREADS, 0, (cudaStream_t)stream>>>(
      vals, ids, out_v, out_ids, n_q, kk, n_valid, k, seg, id_bytes);
  return (int)cudaGetLastError();
}

// vals [P, n_q, kk] f32 (contiguous) -> each query's top-k among its first
// n_valid clamped columns, in column order: sel_v f32 / sel_c int32
// [n_q, k].  1 <= k <= n_valid <= P * kk.  Returns cudaError_t.
extern "C" int topk_merge_select(const float* vals, float* sel_v, int* sel_c,
                                 int n_p, int n_q, int kk, int n_valid, int k,
                                 void* stream) {
  if (n_q <= 0 || n_p <= 0 || kk <= 0) return 0;
  if (bad_args(n_p, kk, n_valid, k, 4)) return (int)cudaErrorInvalidValue;
  pandadb::radix_select<<<n_q, pandadb::SEL_THREADS, 0,
                          (cudaStream_t)stream>>>(
      MergeWindows{vals, n_q, kk, n_valid}, k, sel_v, sel_c);
  return (int)cudaGetLastError();
}

// v / pos [n_q, k]: the selection's values after a stable descending sort
// and the sort's int64 permutation; sel_c [n_q, k] the selection's columns;
// ids [P, n_q, kk] (id_bytes 4 or 8 a value).  Restores -inf in v in place
// and writes out_ids [n_q, k].  Returns cudaError_t.
extern "C" int topk_merge_epilogue(float* v, const long long* pos,
                                   const int* sel_c, const void* ids,
                                   int id_bytes, void* out_ids, int n_q,
                                   int kk, int k, void* stream) {
  if (n_q <= 0 || k <= 0) return 0;
  if (kk <= 0 || (id_bytes != 4 && id_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)n_q * k;
  merge_epilogue<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                   (cudaStream_t)stream>>>(v, pos, sel_c, ids, out_ids, n_q,
                                           kk, k, id_bytes);
  return (int)cudaGetLastError();
}
