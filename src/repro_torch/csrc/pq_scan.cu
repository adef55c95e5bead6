// pq_scan: product-quantization ADC scan + per-tile top-L for Hopper.
//
// Replaces the Pallas kernels pq_adc_topk_pallas (body _pq_kernel) and
// pq_adc_topk_ext_pallas (body _pq_kernel_ext) of
// src/repro/kernels/pq_scan/pq_scan.py, as one kernel templated on EXT:
//   s[q, n] = sum_{j < M} luts[q, j, codes[n, j]]                (plain)
//   s[q, n] = (s + bias[n]) + cscores[q, row_bucket[n]]          (EXT)
// with rows whose probe_mask[q, row_bucket[n]] is 0 (EXT, when a mask is
// given) and rows >= n_valid pinned to NEG.  The sum runs j = 0..M-1 from
// 0.0f with round-to-nearest adds, the order of the XLA twin
// (src/repro/kernels/pq_scan/ops.py), so scores match it bitwise.
//
// Bound: the scan reads M bytes of codes per row and does Q * M table
// lookups and adds per row; at the main path's shapes (Q = 256, M = 16) the
// lookups bound it, not the 16 MB of codes.  The Pallas body turns the
// lookups into a one-hot matmul, which pays only on a TPU's matrix unit.
// Here each block stages the LUTs of qb queries in shared memory (16 KB per
// query at M = 16, K = 256) once, then walks a run of row tiles: each thread
// reads one row's code bytes and gathers its LUT entries from shared memory
// for every staged query, so each code byte read from device memory serves
// qb queries.  The tile top-L is the shared bitonic sort (tile_topk.cuh).
#include "tile_topk.cuh"

namespace {

using pandadb::NEG;

constexpr int BN = 256;      // rows per tile == threads per block
constexpr int QB_MAX = 8;    // queries per block, at most
constexpr int SMEM_BUDGET = 96 * 1024;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int MAX_GRID_Y = 65535;
constexpr int TARGET_BLOCKS = 132 * 8;  // a few waves over the SMs

template <bool EXT>
__global__ void __launch_bounds__(BN)
pq_tile_topk(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
             const float* __restrict__ bias, const int* __restrict__ row_bucket,
             const float* __restrict__ cscores,
             const uint8_t* __restrict__ probe_mask, float* __restrict__ cand_v,
             int* __restrict__ cand_i, int n_q, int n_rows, int m, int ksub,
             int mb, int n_valid, int topl, int qb, int tiles_per_block) {
  extern __shared__ float smem[];
  const int mk = m * ksub;
  float* lut_s = smem;                                  // [qb, m * ksub]
  float* sv = lut_s + (size_t)qb * mk;                  // [qb, BN]
  int* si = reinterpret_cast<int*>(sv + qb * BN);       // [qb, BN]

  const int t = threadIdx.x;
  const int q0 = blockIdx.y * qb;
  const int nq = min(qb, n_q - q0);
  for (int e = t; e < nq * mk; e += BN) lut_s[e] = luts[(size_t)q0 * mk + e];
  __syncthreads();

  const int n_tiles = (n_rows + BN - 1) / BN;
  const int tile_lo = blockIdx.x * tiles_per_block;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_block);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int row = tile * BN + t;
    const bool live = row < n_valid;
    float acc[QB_MAX];
#pragma unroll
    for (int i = 0; i < QB_MAX; ++i) acc[i] = 0.f;
    if (live) {
      const uint8_t* cr = codes + (size_t)row * m;
      for (int j = 0; j < m; ++j) {
        const float* lj = lut_s + j * ksub + cr[j];
#pragma unroll
        for (int i = 0; i < QB_MAX; ++i)
          if (i < nq) acc[i] = __fadd_rn(acc[i], lj[(size_t)i * mk]);
      }
    }
    float b = 0.f;
    int bk = 0;
    if (EXT && live) {
      b = bias[row];
      bk = row_bucket[row];
    }
#pragma unroll
    for (int i = 0; i < QB_MAX; ++i) {
      if (i >= nq) break;
      float s = acc[i];
      bool keep = live;
      if (EXT && live) {
        const size_t qo = (size_t)(q0 + i) * mb + bk;
        s = __fadd_rn(__fadd_rn(s, b), cscores[qo]);
        if (probe_mask != nullptr && probe_mask[qo] == 0) keep = false;
      }
      sv[i * BN + t] = keep ? s : NEG;
      si[i * BN + t] = row;
    }
    __syncthreads();
    if (topl < BN) pandadb::sort_runs(sv, si, nq, BN);
    pandadb::write_candidates(sv, si, nq, BN, topl, q0, tile, n_tiles, cand_v,
                              cand_i);
    __syncthreads();  // the next tile overwrites sv/si
  }
}

template <bool EXT>
int launch(const float* luts, const uint8_t* codes, const float* bias,
           const int* row_bucket, const float* cscores,
           const uint8_t* probe_mask, float* cand_v, int* cand_i, int n_q,
           int n_rows, int m, int ksub, int mb, int n_valid, int topl,
           cudaStream_t stream) {
  const size_t per_query = (size_t)m * ksub * sizeof(float) + BN * 8;
  int qb = (int)(SMEM_BUDGET / per_query);
  qb = max(1, min(min(qb, QB_MAX), n_q));
  const size_t smem = qb * per_query;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pq_tile_topk<EXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_rows + BN - 1) / BN;
  const size_t width = (size_t)n_tiles * topl;
  const int q_step = MAX_GRID_Y * qb;
  for (int qa = 0; qa < n_q; qa += q_step) {
    const int nq = min(q_step, n_q - qa);
    const int gy = (nq + qb - 1) / qb;
    int gx = max(1, min(n_tiles, TARGET_BLOCKS / gy));
    const int tiles_per_block = (n_tiles + gx - 1) / gx;
    gx = (n_tiles + tiles_per_block - 1) / tiles_per_block;
    dim3 grid(gx, gy);
    pq_tile_topk<EXT><<<grid, BN, smem, stream>>>(
        luts + (size_t)qa * m * ksub, codes, bias, row_bucket,
        EXT ? cscores + (size_t)qa * mb : nullptr,
        (EXT && probe_mask != nullptr) ? probe_mask + (size_t)qa * mb
                                       : nullptr,
        cand_v + (size_t)qa * width, cand_i + (size_t)qa * width, nq, n_rows,
        m, ksub, mb, n_valid, topl, qb, tiles_per_block);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// luts [n_q, m, ksub] f32, codes [n_rows, m] uint8 -> cand_v f32 / cand_i
// int32 [n_q, ceil(n_rows / 256) * topl]; topl in [1, 256].  With ext != 0,
// bias [n_rows] f32, row_bucket [n_rows] int32 in [0, mb), cscores [n_q, mb]
// f32 and probe_mask [n_q, mb] uint8 (may be null: no mask) join the score.
// Returns cudaError_t.
extern "C" int pq_scan_tile_topk(const float* luts, const uint8_t* codes,
                                 const float* bias, const int* row_bucket,
                                 const float* cscores,
                                 const uint8_t* probe_mask, float* cand_v,
                                 int* cand_i, int n_q, int n_rows, int m,
                                 int ksub, int mb, int n_valid, int topl,
                                 int ext, void* stream) {
  if (n_q <= 0 || n_rows <= 0) return 0;
  if (topl < 1 || topl > BN || m <= 0 || ksub <= 0 || ksub > 256 ||
      n_valid > n_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ext) {
    if (bias == nullptr || row_bucket == nullptr || cscores == nullptr ||
        mb <= 0)
      return (int)cudaErrorInvalidValue;
    return launch<true>(luts, codes, bias, row_bucket, cscores, probe_mask,
                        cand_v, cand_i, n_q, n_rows, m, ksub, mb, n_valid,
                        topl, s);
  }
  return launch<false>(luts, codes, nullptr, nullptr, nullptr, nullptr,
                       cand_v, cand_i, n_q, n_rows, m, ksub, 1, n_valid, topl,
                       s);
}

// The tile width the candidates are laid out in.
extern "C" int pq_scan_tile_rows() { return BN; }
