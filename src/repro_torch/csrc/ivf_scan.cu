// ivf_scan: fused similarity scan + per-tile top-L for Hopper.
//
// Replaces the Pallas kernel ivf_scan_topk_pallas (body _ivf_kernel) of
// src/repro/kernels/ivf_scan/ivf_scan.py.  Scores, higher = closer:
//   l2: -(|q|^2 - 2 q.c + |c|^2)     ip: q.c
// (cosine is ip on rows the wrapper normalised first, as the reference does).
// Rows >= n_valid are pinned to NEG.  Output: per query and tile of BN rows,
// the tile's first `topl` (value, row) pairs in lax.top_k order; the wrapper
// merges them with a stable sort.
//
// Bound: at the main path's shapes (Q in the hundreds, d = 128) the scan does
// 2 Q N d operations on 4 N d bytes, so it is bound by float32 operations, not
// bytes.  They stay float32 FMAs on the SIMT cores: TF32 tensor cores would
// change scores, and changed scores change ids.  Each block scores QB queries
// against one tile of BN rows; the tile is staged through shared memory DK
// columns at a time, so each corpus value read from device memory feeds QB
// FMAs, and |c|^2 and |q|^2 come out of the same pass.  The tile top-L then
// sorts the QB x BN scores in shared memory (tile_topk.cuh).
#include "tile_topk.cuh"

namespace {

using pandadb::NEG;

constexpr int BN = 256;  // corpus rows per tile == threads per block
constexpr int QB = 8;    // queries per block
constexpr int DK = 16;   // feature columns staged per step
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(BN)
ivf_tile_topk(const float* __restrict__ q, const float* __restrict__ c,
              float* __restrict__ cand_v, int* __restrict__ cand_i, int n_q,
              int n_rows, int d, int n_valid, int topl, int l2) {
  __shared__ float qs[QB][DK];
  __shared__ float cs[BN][DK + 1];  // +1: row-per-thread reads skip bank conflicts
  __shared__ float q2s[QB];
  __shared__ float sv[QB * BN];
  __shared__ int si[QB * BN];

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int row0 = tile * BN;

  float acc[QB];
#pragma unroll
  for (int i = 0; i < QB; ++i) acc[i] = 0.f;
  float c2 = 0.f;
  float q2 = 0.f;  // thread t < QB: |q|^2 of query q0 + t

  for (int k0 = 0; k0 < d; k0 += DK) {
    for (int e = t; e < BN * DK; e += BN) {
      const int r = e / DK, j = e - r * DK;
      const int gr = row0 + r, gj = k0 + j;
      cs[r][j] = (gr < n_rows && gj < d) ? c[(size_t)gr * d + gj] : 0.f;
    }
    if (t < QB * DK) {
      const int i = t / DK, j = t - i * DK;
      const int gq = q0 + i, gj = k0 + j;
      qs[i][j] = (gq < n_q && gj < d) ? q[(size_t)gq * d + gj] : 0.f;
    }
    __syncthreads();
    if (t < QB) {
      for (int j = 0; j < DK; ++j) q2 = fmaf(qs[t][j], qs[t][j], q2);
    }
#pragma unroll
    for (int j = 0; j < DK; ++j) {
      const float cv = cs[t][j];
      c2 = fmaf(cv, cv, c2);
#pragma unroll
      for (int i = 0; i < QB; ++i) acc[i] = fmaf(qs[i][j], cv, acc[i]);
    }
    __syncthreads();
  }
  if (t < QB) q2s[t] = q2;
  __syncthreads();

  const int row = row0 + t;
#pragma unroll
  for (int i = 0; i < QB; ++i) {
    float s = acc[i];
    if (l2) {
      // the reference's -(q2 - 2 s + c2), rounded step by step (no FMA)
      s = -__fadd_rn(__fsub_rn(q2s[i], __fmul_rn(2.0f, s)), c2);
    }
    sv[i * BN + t] = row < n_valid ? s : NEG;
    si[i * BN + t] = row;
  }
  __syncthreads();
  if (topl < BN) pandadb::sort_runs(sv, si, QB, BN);
  const int n_seg = min(QB, n_q - q0);
  pandadb::write_candidates(sv, si, n_seg, BN, topl, q0, tile, gridDim.x,
                            cand_v, cand_i);
}

}  // namespace

// q [n_q, d] f32, c [n_rows, d] f32 -> cand_v f32 / cand_i int32
// [n_q, ceil(n_rows / 256) * topl]; topl in [1, 256].  Returns cudaError_t.
extern "C" int ivf_scan_tile_topk(const float* q, const float* c,
                                  float* cand_v, int* cand_i, int n_q,
                                  int n_rows, int d, int n_valid, int topl,
                                  int l2, void* stream) {
  if (n_q <= 0 || n_rows <= 0) return 0;
  if (topl < 1 || topl > BN || d <= 0 || n_valid > n_rows)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n_rows + BN - 1) / BN;
  const size_t width = (size_t)n_tiles * topl;
  const int q_step = MAX_GRID_Y * QB;
  for (int qa = 0; qa < n_q; qa += q_step) {
    const int nq = min(q_step, n_q - qa);
    dim3 grid(n_tiles, (nq + QB - 1) / QB);
    ivf_tile_topk<<<grid, BN, 0, (cudaStream_t)stream>>>(
        q + (size_t)qa * d, c, cand_v + (size_t)qa * width,
        cand_i + (size_t)qa * width, nq, n_rows, d, n_valid, topl, l2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The tile width the candidates are laid out in.
extern "C" int ivf_scan_tile_rows() { return BN; }
