// Top-k selection by radix select, shared by the scan and merge kernels
// (ivf_scan.cu, pq_scan.cu, topk_merge.cu).
//
// One block per query row finds the k-th largest of the row's first
// n_valid values by a radix select over an order-preserving uint32 key:
// three digit passes of 11, 11 and 10 bits, each a histogram (four in
// shared memory, one per four warps, summed after) of the values that
// still match the digits chosen so far, stopping early once a digit's bin
// holds exactly the values still needed.  It then compacts, in column
// order, every value above that threshold and the first values equal to
// it: k survivors, which a stable sort by value (the wrapper's, over
// [Q, k] only) puts in lax.top_k order (value descending, ties to the
// lower column).  The cost is the same for every k, where a sort grows
// with it; the passes read the row at most four times.
//
// The selection reads a row through a Rows type: rows.row(b) gives block
// b's row, whose n values it selects from, col0 the column of its first,
// and whose load(i0, n, x) fills x[0 .. PER) with the values at i0 .. (i0 a
// multiple of PER), those at or past n as NEG.  ScratchRows reads a
// contiguous [Q, ld] float32 matrix (the scan kernels' scores), each row
// whole or, when there are too few queries to fill the card, cut into
// segments that blocks select from on their own: the union of the
// segments' top-k holds the row's top-k, in column order (segment after
// segment), so the wrapper's stable sort of the [Q, segments * k]
// survivors gives the row's.  topk_merge.cu gives its own reader over the
// shard windows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pandadb {

// Masked score: below every real score.  The reference's Pallas kernels pin
// padding and non-probed rows to the same value.
constexpr float NEG = -3.0e38f;

constexpr int SEL_THREADS = 512;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int PER = 8;                 // values a thread takes a step
constexpr int STEP = PER * SEL_THREADS;
constexpr int BINS = 2048;             // 11-bit digits: 11 + 11 + 10 bits
constexpr int SUBS = 4;                // histograms, one per 4 warps
static_assert(BINS == 4 * SEL_THREADS && SUBS == 4, "four bins a thread");

// uint32 key in the order of the float's value; -0 and +0 get one key
__device__ __forceinline__ uint32_t order_key(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The first n_valid columns of the rows of a [Q, ld] float32 matrix, ld % 4
// == 0 and 16-byte aligned, read as float4 where a whole one lies below n.
// Block b takes segment b % n_seg of row b / n_seg: seg_len columns (a
// multiple of 4), the last segment up to n_valid.
struct ScratchRows {
  const float* scores;
  size_t ld;
  int n_valid, n_seg, seg_len;

  struct Row {
    const float* p;
    int n, col0;
    __device__ __forceinline__ void load(int i0, int n, float (&x)[PER]) const {
#pragma unroll
      for (int h = 0; h < PER; h += 4) {
        const int j = i0 + h;
        if (j + 3 < n) {
          const float4 v = *reinterpret_cast<const float4*>(p + j);
          x[h] = v.x; x[h + 1] = v.y; x[h + 2] = v.z; x[h + 3] = v.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) x[h + u] = j + u < n ? p[j + u] : NEG;
        }
      }
    }
  };

  __device__ __forceinline__ Row row(int b) const {
    const int q = b / n_seg, s = b - q * n_seg;
    const int col0 = s * seg_len;
    return Row{scores + (size_t)q * ld + col0,
               s == n_seg - 1 ? n_valid - col0 : seg_len, col0};
  }
};

// Exclusive prefix sum of one int a thread over the block, with the total.
__device__ __forceinline__ int block_scan(int x, int* warp_tot, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < SEL_WARPS; ++w) {
    const int t = warp_tot[w];
    before += w < warp ? t : 0;
    all += t;
  }
  __syncthreads();                             // warp_tot is reused
  *total = all;
  return before + incl - x;
}

// One block per row (SEL_THREADS threads): the top-k of the n values of
// rows.row(blockIdx.x), in column order, to out_v / out_i [k] (the
// columns counted from the row's col0); 1 <= k <= n.
template <class Rows>
__global__ void __launch_bounds__(SEL_THREADS)
radix_select(Rows rows, int k, float* __restrict__ out_v,
             int* __restrict__ out_i) {
  __shared__ unsigned hist[SUBS][BINS];
  __shared__ int warp_tot[SEL_WARPS];
  __shared__ uint32_t s_digit;
  __shared__ int s_need, s_exact;
  const typename Rows::Row row = rows.row(blockIdx.x);
  const int n_valid = row.n;
  unsigned* my_hist = hist[threadIdx.x / 32 / (SEL_WARPS / SUBS)];

  // the values whose key, under mask, equals prefix hold the k-th largest;
  // `need` of them belong to the top-k, every value above them does too
  uint32_t prefix = 0u, mask = 0u;
  int need = k;
  for (int pass = 0; pass < 3; ++pass) {
    const int shift = pass == 0 ? 21 : pass == 1 ? 10 : 0;
    const uint32_t digits = pass == 2 ? 0x3FFu : 0x7FFu;
    for (int e = threadIdx.x; e < SUBS * BINS; e += SEL_THREADS)
      (&hist[0][0])[e] = 0u;
    __syncthreads();
    for (int base = 0; base < n_valid; base += STEP) {
      const int i0 = base + PER * threadIdx.x;
      float x[PER];
      row.load(i0, n_valid, x);
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const uint32_t key = order_key(x[u]);
        if (i0 + u < n_valid && (key & mask) == prefix)
          atomicAdd(&my_hist[(key >> shift) & digits], 1u);
      }
    }
    __syncthreads();
    // thread t holds digits BINS - 1 - 4t .. BINS - 4 - 4t, largest first
    unsigned cnt[4], sum = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = BINS - 1 - 4 * threadIdx.x - j;
      cnt[j] = hist[0][d] + hist[1][d] + hist[2][d] + hist[3][d];
      sum += cnt[j];
    }
    int tot;
    unsigned run = (unsigned)block_scan((int)sum, warp_tot, &tot);
    const unsigned want = (unsigned)need;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (run < want && want <= run + cnt[j]) {
        s_digit = BINS - 1 - 4 * threadIdx.x - j;
        s_need = (int)(want - run);
        s_exact = cnt[j] == want - run;
      }
      run += cnt[j];
    }
    __syncthreads();
    prefix |= s_digit << shift;
    mask |= digits << shift;
    need = s_need;
    if (s_exact) break;                        // the bin is all taken
  }

  // compaction in column order: above the threshold, and the first `need`
  // values at it (lax.top_k's tie rule)
  float* ov = out_v + (size_t)blockIdx.x * k;
  int* oi = out_i + (size_t)blockIdx.x * k;
  int taken = 0, eq_seen = 0;
  for (int base = 0; base < n_valid && taken < k; base += STEP) {
    const int i0 = base + PER * threadIdx.x;
    float x[PER];
    row.load(i0, n_valid, x);
    bool gt[PER], eq[PER];
    int n_gt = 0, n_eq = 0;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const uint32_t km = order_key(x[u]) & mask;
      const bool in = i0 + u < n_valid;
      gt[u] = in && km > prefix;
      eq[u] = in && km == prefix;
      n_gt += gt[u];
      n_eq += eq[u];
    }
    int tot;                                   // counts < 2^16 a step
    const int before = block_scan((n_eq << 16) | n_gt, warp_tot, &tot);
    int eq_rank = eq_seen + (before >> 16);    // values at the threshold before
    int pos = taken + (before & 0xFFFF) +
              min(max(need - eq_seen, 0), before >> 16);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      if (gt[u] || (eq[u] && eq_rank < need)) {
        ov[pos] = x[u];
        oi[pos] = row.col0 + i0 + u;
        ++pos;
      }
      eq_rank += eq[u];
    }
    taken += (tot & 0xFFFF) + min(max(need - eq_seen, 0), tot >> 16);
    eq_seen += tot >> 16;
  }
}

}  // namespace pandadb
