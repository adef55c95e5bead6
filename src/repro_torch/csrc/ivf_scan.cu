// ivf_scan: exact similarity scan + top-k for Hopper.
//
// Replaces the Pallas kernel ivf_scan_topk_pallas (body _ivf_kernel) of
// src/repro/kernels/ivf_scan/ivf_scan.py, which scores a [Q, BN] tile in
// VMEM and keeps its top-L; its XLA twin (_scan_topk_xla) serves the k the
// kernel's gate refuses.  Scores, higher = closer:
//   l2: -(|q|^2 - 2 q.c + |c|^2)     ip: q.c
// (cosine is ip on rows the wrapper normalised first, as the reference does).
// Rows >= n_valid are never returned.  Ties go to the lower row, as
// lax.top_k.
//
// Bound: at the main path's shapes (Q in the hundreds, d = 128) the scan does
// 2 Q N d operations on 4 N d bytes, so it is bound by float32 operations, not
// bytes.  They stay float32 FMAs on the SIMT cores: TF32 tensor cores would
// change scores, and changed scores change ids.
//
// ivf_score is a register-tiled product: a block scores 128 queries against
// 128 rows, each thread an 8 x 8 micro-tile, so each value read from shared
// memory feeds 8 FMAs; slices of 16 features of both tiles are
// double-buffered with cp.async.  The l2 norms come from ivf_norms, one
// warp a row.  The scores go to a [Q, N] scratch matrix.
//
// Its MASKED instantiation is the index's dense probe scan (the reference's
// masked_scan_topk, plain jnp there): one scan of the whole table in which
// row n scores -inf for query q unless probe_mask[q, row_bucket[n]] is set,
// written in the epilogue, where the staging registers are free.  -inf lies
// below every finite score in radix_select's order and its ties go to the
// lower row, as in the full stable sort that formulation used.  The plain
// instantiation reads no mask.
//
// The selection is radix_select.cuh's, over the scratch rows: a radix
// select of each query's k-th largest score, then, in row order, the rows
// above it and the first rows equal to it: k survivors, which a stable sort
// by value (the wrapper's, over [Q, k] only) puts in lax.top_k order.  The
// Pallas kernel's per-tile top-L has no counterpart: the selection costs
// the same for every k, where a tile sort grows with it, and measured
// faster at every k on the card.
#include <cmath>

#include "hopper.cuh"
#include "radix_select.cuh"

namespace {

constexpr int MAX_GRID_Y = 65535;

constexpr int SQ = 128;          // queries per scoring block
constexpr int SN = 128;          // corpus rows per scoring block
constexpr int SK = 16;           // features per stage
constexpr int SLD = SK + 4;      // shared row stride: float4 reads of 8
                                 // rows 80 bytes apart miss no bank twice
constexpr int STHREADS = 256;    // 16 x 16 threads, 8 x 8 scores each

// Starts the copy of a 128-row x 16-feature slice (rows row0.., features
// k0..) of a [n, d] float32 matrix into dst [128][SLD]; zeros outside.
__device__ __forceinline__ void load_slice(float* dst, const float* src,
                                           int row0, int n, int d, int k0,
                                           bool vec) {
#pragma unroll
  for (int e = threadIdx.x; e < 128 * SK / 4; e += STHREADS) {
    const int r = e / (SK / 4);
    const int col = (e % (SK / 4)) * 4;
    const int row = row0 + r;
    float* to = dst + r * SLD + col;
    if (vec) {                                 // d % 4 == 0: whole chunks
      const bool ok = row < n && k0 + col < d;
      pandadb::cp_async16(to, src + (ok ? (size_t)row * d + k0 + col : 0),
                          ok ? 16 : 0);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = row < n && k0 + col + u < d;
        pandadb::cp_async4(to + u,
                           src + (ok ? (size_t)row * d + k0 + col + u : 0),
                           ok ? 4 : 0);
      }
    }
  }
}

// |x|^2 of each row of x [n, d], one warp a row
__global__ void __launch_bounds__(256)
ivf_norms(const float* __restrict__ x, float* __restrict__ out, int n, int d) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const float* r = x + (size_t)row * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) s = fmaf(r[j], r[j], s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) out[row] = s;
}

// q2 [n_q] and c2 [n_rows] are the rows' |x|^2 (read for l2 only);
// row_bucket [n_rows] in [0, m) and probe_mask [n_q, m] are read when MASKED
// (last, so the plain instantiation's other parameters keep their offsets)
template <bool MASKED>
__global__ void __launch_bounds__(STHREADS, 2)
ivf_score(const float* __restrict__ q, const float* __restrict__ c,
          const float* __restrict__ q2, const float* __restrict__ c2,
          float* __restrict__ scores, int n_q, int n_rows, int d, size_t ld,
          int l2, const int* __restrict__ row_bucket,
          const uint8_t* __restrict__ probe_mask, int m) {
  __shared__ __align__(16) float qs[2][SQ * SLD];
  __shared__ __align__(16) float cs[2][SN * SLD];
  const int tx = threadIdx.x % 16;             // rows tx + 16 j
  const int ty = threadIdx.x / 16;             // queries ty + 16 i
  const int q0 = blockIdx.y * SQ;
  const int r0 = blockIdx.x * SN;
  const bool vec = d % 4 == 0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const int n_k = (d + SK - 1) / SK;
  load_slice(qs[0], q, q0, n_q, d, 0, vec);
  load_slice(cs[0], c, r0, n_rows, d, 0, vec);
  pandadb::cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {                        // the next slice, under this one
      load_slice(qs[(kt + 1) & 1], q, q0, n_q, d, (kt + 1) * SK, vec);
      load_slice(cs[(kt + 1) & 1], c, r0, n_rows, d, (kt + 1) * SK, vec);
      pandadb::cp_async_commit();
      pandadb::cp_async_wait<1>();
    } else {
      pandadb::cp_async_wait<0>();
    }
    __syncthreads();
    const float* qt = qs[kt & 1];
    const float* ct = cs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < SK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(qt + (ty + 16 * i) * SLD + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(ct + (tx + 16 * j) * SLD + kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
    __syncthreads();                           // the stage may be refilled
  }

  [[maybe_unused]] int bucket[8];              // this thread's rows' buckets
  if constexpr (MASKED) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = r0 + tx + 16 * j;
      bucket[j] = row < n_rows ? row_bucket[row] : 0;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= n_q) continue;
    const float qn = l2 ? q2[qi] : 0.f;
    float* out = scores + (size_t)qi * ld;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = r0 + tx + 16 * j;
      if (row >= n_rows) continue;
      float s = acc[i][j];
      if (l2) {
        // the reference's -(q2 - 2 s + c2), rounded step by step (no FMA)
        s = -__fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, s)), c2[row]);
      }
      if constexpr (MASKED) {
        if (probe_mask[(size_t)qi * m + bucket[j]] == 0) s = -INFINITY;
      }
      out[row] = s;
    }
  }
}

}  // namespace

// q [n_q, d] f32, c [n_rows, d] f32 -> scores [n_q, ld] f32 (columns
// < n_rows written), ld >= n_rows; norms [n_q + n_rows] f32 is scratch
// for the rows' |x|^2 (l2 only).  With a probe_mask (else null) row n of
// query q scores -inf unless probe_mask[q * m + row_bucket[n]] != 0:
// row_bucket [n_rows] int32 in [0, m), probe_mask [n_q, m] uint8, m >= 1.
// Returns cudaError_t.
extern "C" int ivf_scan_scores(const float* q, const float* c, float* scores,
                               float* norms, int n_q, int n_rows, int d,
                               long long ld, int l2, const int* row_bucket,
                               const uint8_t* probe_mask, int m,
                               void* stream) {
  if (n_q <= 0 || n_rows <= 0) return 0;
  if (d <= 0 || ld < n_rows || (n_q + SQ - 1) / SQ > MAX_GRID_Y ||
      (probe_mask != nullptr && (row_bucket == nullptr || m < 1)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (l2) {
    ivf_norms<<<(n_q + 7) / 8, 256, 0, st>>>(q, norms, n_q, d);
    ivf_norms<<<(n_rows + 7) / 8, 256, 0, st>>>(c, norms + n_q, n_rows, d);
  }
  const dim3 grid((n_rows + SN - 1) / SN, (n_q + SQ - 1) / SQ);
  if (probe_mask != nullptr)
    ivf_score<true><<<grid, STHREADS, 0, st>>>(
        q, c, norms, norms + n_q, scores, n_q, n_rows, d, (size_t)ld, l2,
        row_bucket, probe_mask, m);
  else
    ivf_score<false><<<grid, STHREADS, 0, st>>>(
        q, c, norms, norms + n_q, scores, n_q, n_rows, d, (size_t)ld, l2,
        nullptr, nullptr, 0);
  return (int)cudaGetLastError();
}

// scores [n_q, ld] f32 (ld % 4 == 0, 16-byte aligned) -> the top-k rows
// among the first n_valid columns of each, in row order: out_v f32 / out_i
// int32 [n_q, k]; 1 <= k <= n_valid <= ld.  Returns cudaError_t.
extern "C" int ivf_scan_select(const float* scores, long long ld, int n_q,
                               int n_valid, int k, float* out_v, int* out_i,
                               void* stream) {
  if (n_q <= 0) return 0;
  if (k < 1 || k > n_valid || n_valid > ld || ld % 4 != 0)
    return (int)cudaErrorInvalidValue;
  pandadb::radix_select<<<n_q, pandadb::SEL_THREADS, 0,
                          (cudaStream_t)stream>>>(
      pandadb::ScratchRows{scores, (size_t)ld, n_valid, 1, n_valid}, k, out_v,
      out_i);
  return (int)cudaGetLastError();
}
