// pq_scan: product-quantization ADC scan + top-k for Hopper.
//
// Replaces the Pallas kernels pq_adc_topk_pallas (body _pq_kernel) and
// pq_adc_topk_ext_pallas (body _pq_kernel_ext) of
// src/repro/kernels/pq_scan/pq_scan.py, as one scoring kernel templated on
// EXT:
//   s[q, n] = sum_{j < M} luts[q, j, codes[n, j]]                (plain)
//   s[q, n] = (s + bias[n]) + cscores[q, row_bucket[n]]          (EXT)
// with rows whose probe_mask[q, row_bucket[n]] is 0 (EXT, when a mask is
// given) pinned to NEG.  The sum runs j = 0..M-1 from 0.0f with
// round-to-nearest adds, the order of the XLA twin
// (src/repro/kernels/pq_scan/ops.py), so scores match it bitwise.
//
// Bound: the scan reads M bytes of codes per row and does Q * M table
// lookups and adds per row; at the main path's shapes (Q = 256, M = 16) the
// lookups bound it, not the 16 MB of codes.  The Pallas body turns the
// lookups into a one-hot matmul, which pays only on a TPU's matrix unit.
// Here the lookups are shared-memory gathers at random addresses: their
// floor is the shared-memory rate and its bank conflicts.
//
// pq_score: a block stages the LUTs of QS queries in shared memory (QS = 4,
// 64 KB at M = 16, K = 256, or 1 where there are few queries: the
// wrapper's query_slots) interleaved as [j][code][query], so that one
// 16-byte load gathers one entry for four queries.  Each thread scores one
// row at a time: its M code bytes in one 16-byte load where M = 16 (byte
// by byte otherwise), then the in-order sums for the QS queries, written
// to a [Q, ld] float32 scratch matrix (rows past n_valid are not scored).
// A block walks a contiguous run of rows, so a code row read from device
// memory serves QS queries.
//
// The selection is radix_select.cuh's over the scratch rows (pq_scan_select):
// the k survivors in row order, which the wrapper's stable sort over [Q, k]
// puts in lax.top_k order.  No per-tile top-L and no sort over all N
// columns: the selection costs the same for every k.  With few queries (a
// probe group of the adc path) one block a row would leave most SMs idle,
// so the wrapper cuts each row into segments, a block each, and sorts the
// segments' survivors.
#include "radix_select.cuh"

namespace {

using pandadb::NEG;

constexpr int THREADS = 512;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int MAX_GRID_Y = 65535;

// acc[i] += e[i] for the QS query slots of one staged LUT entry, in
// float4 loads where QS is a multiple of 4
template <int QS>
__device__ __forceinline__ void add_entry(float (&acc)[QS], const float* e) {
  if constexpr (QS % 4 == 0) {
    const float4* e4 = reinterpret_cast<const float4*>(e);
#pragma unroll
    for (int s = 0; s < QS / 4; ++s) {
      const float4 v = e4[s];
      acc[4 * s] = __fadd_rn(acc[4 * s], v.x);
      acc[4 * s + 1] = __fadd_rn(acc[4 * s + 1], v.y);
      acc[4 * s + 2] = __fadd_rn(acc[4 * s + 2], v.z);
      acc[4 * s + 3] = __fadd_rn(acc[4 * s + 3], v.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < QS; ++i) acc[i] = __fadd_rn(acc[i], e[i]);
  }
}

// Block (x, y): queries x * QS .. of n_q, rows y * rows_per_block .. below
// n_valid.  M16: m == 16 and codes 16-byte aligned.
template <bool EXT, int QS, bool M16>
__global__ void __launch_bounds__(THREADS)
pq_score(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
         const float* __restrict__ bias, const int* __restrict__ row_bucket,
         const float* __restrict__ cscores,
         const uint8_t* __restrict__ probe_mask, float* __restrict__ scores,
         size_t ld, int n_q, int n_valid, int m, int ksub, int mb,
         int rows_per_block) {
  extern __shared__ float4 smem4[];
  float* lut = reinterpret_cast<float*>(smem4);        // [m * ksub][QS]
  const int mk = m * ksub;
  const int q0 = blockIdx.x * QS;
  const int nq = min(QS, n_q - q0);
  for (int e = threadIdx.x; e < QS * mk; e += THREADS) {
    const int i = e / mk;
    const int jc = e - i * mk;
    lut[jc * QS + i] = i < nq ? luts[(size_t)(q0 + i) * mk + jc] : 0.f;
  }
  __syncthreads();

  const int r_lo = blockIdx.y * rows_per_block;
  const int r_hi = min(n_valid, r_lo + rows_per_block);
  for (int row = r_lo + threadIdx.x; row < r_hi; row += THREADS) {
    float acc[QS];
#pragma unroll
    for (int i = 0; i < QS; ++i) acc[i] = 0.f;
    if (M16) {
      // two code words (8 subspaces) an iteration, which bounds the
      // shared-memory loads in flight
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(codes) + row);
#pragma unroll 2
      for (int jw = 0; jw < 4; ++jw) {
        const uint32_t word = jw == 0 ? w.x : jw == 1 ? w.y : jw == 2 ? w.z
                                                                      : w.w;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t c = (word >> (8 * b)) & 0xFFu;
          add_entry<QS>(acc, lut + ((4 * jw + b) * ksub + c) * QS);
        }
      }
    } else {
      const uint8_t* cr = codes + (size_t)row * m;
      for (int j = 0; j < m; ++j)
        add_entry<QS>(acc, lut + (j * ksub + __ldg(cr + j)) * QS);
    }
    float b = 0.f;
    int bk = 0;
    if (EXT) {
      b = bias[row];
      bk = row_bucket[row];
    }
#pragma unroll
    for (int i = 0; i < QS; ++i) {
      if (i >= nq) break;
      float s = acc[i];
      if (EXT) {
        const size_t qo = (size_t)(q0 + i) * mb + bk;
        s = __fadd_rn(__fadd_rn(s, b), cscores[qo]);
        if (probe_mask != nullptr && probe_mask[qo] == 0) s = NEG;
      }
      scores[(size_t)(q0 + i) * ld + row] = s;
    }
  }
}

struct ScoreArgs {
  const float* luts;
  const uint8_t* codes;
  const float* bias;
  const int* row_bucket;
  const float* cscores;
  const uint8_t* probe_mask;
  float* scores;
  size_t ld;
  int n_q, n_valid, m, ksub, mb;
};

template <bool EXT, int QS, bool M16>
int launch_score(const ScoreArgs& a, cudaStream_t st) {
  const auto kernel = pq_score<EXT, QS, M16>;
  const int smem = QS * a.m * a.ksub * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  // one wave of resident blocks where the query groups allow, each over
  // a run of whole thread-strides of rows
  const int gx = (a.n_q + QS - 1) / QS;
  const int strides = (a.n_valid + THREADS - 1) / THREADS;
  const int want = max(1, n_sm * max(per_sm, 1) / gx);
  int gy = min(min(strides, want), MAX_GRID_Y);
  const int rows_per_block = ((strides + gy - 1) / gy) * THREADS;
  gy = (a.n_valid + rows_per_block - 1) / rows_per_block;
  kernel<<<dim3(gx, gy), THREADS, smem, st>>>(
      a.luts, a.codes, a.bias, a.row_bucket, a.cscores, a.probe_mask,
      a.scores, a.ld, a.n_q, a.n_valid, a.m, a.ksub, a.mb, rows_per_block);
  return (int)cudaGetLastError();
}

template <bool EXT, int QS>
int launch_m(const ScoreArgs& a, cudaStream_t st) {
  const bool m16 = a.m == 16 && (uintptr_t)a.codes % 16 == 0;
  return m16 ? launch_score<EXT, QS, true>(a, st)
             : launch_score<EXT, QS, false>(a, st);
}

template <bool EXT>
int launch_qs(const ScoreArgs& a, int slots, cudaStream_t st) {
  const size_t per_q = (size_t)a.m * a.ksub * sizeof(float);
  if ((size_t)slots * per_q > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (slots == 4) return launch_m<EXT, 4>(a, st);
  if (slots == 1) return launch_m<EXT, 1>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// luts [n_q, m, ksub] f32, codes [>= n_valid, m] uint8 -> scores [n_q, ld]
// f32, columns < n_valid written (ld >= n_valid), by blocks of `slots`
// (4 or 1) queries whose LUTs fit SMEM_MAX.  With ext != 0, bias
// [rows] f32, row_bucket [rows] int32 in [0, mb), cscores [n_q, mb] f32 and
// probe_mask [n_q, mb] uint8 (may be null: no mask) join the score.
// Returns cudaError_t.
extern "C" int pq_scan_scores(const float* luts, const uint8_t* codes,
                              const float* bias, const int* row_bucket,
                              const float* cscores, const uint8_t* probe_mask,
                              float* scores, long long ld, int n_q,
                              int n_valid, int m, int ksub, int mb, int ext,
                              int slots, void* stream) {
  if (n_q <= 0 || n_valid <= 0) return 0;
  if (m <= 0 || ksub <= 0 || ksub > 256 || ld < n_valid)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  ScoreArgs a{luts, codes, bias, row_bucket, cscores, probe_mask, scores,
              (size_t)ld, n_q, n_valid, m, ksub, mb};
  if (ext) {
    if (bias == nullptr || row_bucket == nullptr || cscores == nullptr ||
        mb <= 0)
      return (int)cudaErrorInvalidValue;
    return launch_qs<true>(a, slots, st);
  }
  a.bias = nullptr;
  a.row_bucket = nullptr;
  a.cscores = nullptr;
  a.probe_mask = nullptr;
  a.mb = 1;
  return launch_qs<false>(a, slots, st);
}

// scores [n_q, ld] f32 (ld % 4 == 0, 16-byte aligned) -> the top-k rows
// among the first n_valid columns of each, cut into n_seg segments of
// seg_len = n_valid / n_seg rounded down to 4 columns (the last up to
// n_valid), each segment's top-k in row order: out_v f32 / out_i int32
// [n_q, n_seg * k]; 1 <= k <= seg_len, n_valid <= ld.  Returns cudaError_t.
extern "C" int pq_scan_select(const float* scores, long long ld, int n_q,
                              int n_valid, int k, int n_seg, float* out_v,
                              int* out_i, void* stream) {
  if (n_q <= 0) return 0;
  const int seg_len = n_seg > 0 ? n_valid / n_seg / 4 * 4 : 0;
  if (k < 1 || n_seg < 1 || (n_seg > 1 && k > seg_len) || k > n_valid ||
      n_valid > ld || ld % 4 != 0)
    return (int)cudaErrorInvalidValue;
  pandadb::radix_select<<<n_q * n_seg, pandadb::SEL_THREADS, 0,
                          (cudaStream_t)stream>>>(
      pandadb::ScratchRows{scores, (size_t)ld, n_valid, n_seg,
                           n_seg > 1 ? seg_len : n_valid},
      k, out_v, out_i);
  return (int)cudaGetLastError();
}
