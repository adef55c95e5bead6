// flash_attention_bwd: the gradient of flash_attention (flash_attention.cu)
// with respect to q, k and v, for Hopper.
//
// The reference has no kernel to replace here: its Pallas
// flash_attention_pallas (src/repro/kernels/flash_attention/
// flash_attention.py) has no backward, and the reference trains through
// XLA's derivative of chunked_attention (src/repro/models/attention.py).
// This kernel computes that derivative for the forward kernel's shapes:
// q [B, Sq, H, D], k [B, Skv, KVH, D], v [B, Skv, KVH, Dv], KVH dividing H
// (query head h reads key head h / G, G = H / KVH), query row i at
// position i + Skv - Sq, under causal the keys past it masked; o and dO
// [B, Sq, H, Dv]; m and l [B, H, Sq], the forward's row statistics
// (flash_attention.cu writes them).  The weights are recomputed as
// P = exp(s - m) / l with s the scaled score, m and l kept apart: a row
// that sees no key (Sq > Skv under causal) has m = -1e30, every score
// masked to -1e30, and so P = 1 / l = 1 / Skv for each key, as the
// reference weighs it.  With D = rowsum(dO o) (float32),
// dS = P (dO V^T - D), zero where the mask replaced the score by a
// constant, the gradients are dQ = scale dS K, dK = scale dS^T q and
// dV = P^T dO, a key head's summed over its G query heads.  These are the
// gradients of the float32-weight forward: with bf16_probs the forward
// rounds its weights, and the backward recomputes them unrounded.
//
// Bound: five products of the forward's size (S = Q K^T, dP = dO V^T, dV,
// dK, dQ), 2 B H (pairs) (3 D + 2 Dv) operations over the visible
// (query, key) pairs: bound by operations at the training shape.
//
// bfloat16 (the LM's type), four launches:
// 1. delta: D for every row, one warp a row (bwd_delta).
// 2. pack: each query tile's row statistics (m in base 2, 1 / l, D) in one
//    contiguous 768-byte run, so that the TMA unit can copy it.
// 3. the wgmma kernel: one block per (key tile, key head, batch row), the
//    heaviest tiles first.  A producer warpgroup (its registers given to
//    the consumers) loads the key tile's K and V once and keeps a ring of
//    the steps' Q and dO tiles and statistics in flight by TMA.  The block
//    walks the G query heads and the query tiles of 64 rows that see its
//    keys (and the rows that see no key, which weigh every key).  Two
//    consumer warpgroups each hold 64 of the tile's 128 keys and compute
//    each product once a step on wgmma: S^T = K Q^T and dP^T = V dO^T,
//    P and dS in registers, dS^T stored to shared memory once, dV += P^T
//    dO with A from registers and dK += dS^T Q with A read where dS^T was
//    stored.  After the two warpgroups meet, each takes half of dQ's
//    columns, dQ = dS K over all 128 keys; the step's dQ is staged in the
//    dS^T buffer both have finished reading and added to a float32
//    dq_accum by one TMA reduction.  dK and dV are summed in registers
//    over the whole walk and written once.  Where dK and dV of 64 keys
//    would not fit a thread's registers beside S and dP (D + Dv past 256),
//    the key tile holds 64 keys, warpgroup 0 sums dV and warpgroup 1 dK
//    (BwdTile::SPLIT), and dQ goes to dq_accum by vector atomics.
// 4. cast: dq = scale dq_accum in bf16.
// bf16 products of bf16 inputs are exact in float32, so S and dP are
// float32-faithful.  P and dS are float32 and enter dV, dK and dQ as two
// bf16 terms, hi = bf16(x) and lo = bf16(x - hi) (16 bits of each value),
// so the gradients are those of the float32 arithmetic, rounded once to
// bf16.  P rounded once to bf16 would save a product, but a CPU
// emulation shows it putting dv past the limit the card holds the kernel
// to (tests/test_torch_kernels.py): eight products' worth of tensor-core
// work where the bound counts five.  dq's float32 sums are
// added by reductions (or atomics) in no fixed order, so dq may differ in
// its last bits from run to run; dk and dv do not.
// float32 (the parity configs): SIMT float32 FMAs, three launches, eight
// threads a row (a key in the dK/dV kernel, a query in the dQ kernel),
// each holding an eighth of the row's operands and sums in registers.
#include <cmath>

#include "attention_dtype.cuh"
#include "hopper.cuh"
#include "tma_map.cuh"

namespace {

using bf16 = __nv_bfloat16;
using pandadb::ATTN_NEG;
using pandadb::chunk_of;
using pandadb::make_map;
using pandadb::wgmma_desc;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_GRID = 65535;
constexpr int SMEM_MAX = 232448;     // shared memory a block may use

// 2^x, flushing results below 2^-126 to zero
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as one bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the residues x - bf16(x) of a packed pair, packed again
__device__ __forceinline__ uint32_t pack_rest(float lo, float hi,
                                              uint32_t rounded) {
  return pack_bf16(lo - __uint_as_float(rounded << 16),
                   hi - __uint_as_float(rounded & 0xffff0000u));
}

// A row's statistics, as the kernels read them: m in base 2 (scaled score
// times log2 e), 1 / l, D, and whether the row sees no key.  A row past Sq
// gets 1 / l = 0, so its weights are 0.
struct RowStats {
  float m2, il, dd;
  bool blind;
};

__device__ __forceinline__ RowStats row_stats(const float* m, const float* l,
                                              const float* delta, size_t at,
                                              bool live) {
  RowStats r{0.f, 0.f, 0.f, false};
  if (live) {
    const float mm = m[at];
    r.blind = mm <= 0.5f * ATTN_NEG;
    r.m2 = r.blind ? 0.f : mm * LOG2E;
    r.il = 1.f / fmaxf(l[at], 1e-30f);
    r.dd = delta[at];
  }
  return r;
}

// The weight of one (query, key) pair from its raw dot q . k: a masked pair
// weighs 1 / l in a row that sees no key and nothing elsewhere.
__device__ __forceinline__ float weight(float dot, float scale_log2,
                                        const RowStats& r, bool masked) {
  if (masked) return r.blind ? r.il : 0.f;
  return exp2_ftz(fmaf(dot, scale_log2, -r.m2)) * r.il;
}

// -- 1. D = rowsum(dO o) -------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
          float* __restrict__ delta, int n_rows, int sq, int n_heads,
          int dv) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;   // (b, s, h) order
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const T* orow = o + (size_t)row * dv;
  const T* drow = dout + (size_t)row * dv;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32)
    acc += pandadb::to_float(orow[c]) * pandadb::to_float(drow[c]);
#pragma unroll
  for (int w = 16; w >= 1; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    const int h = row % n_heads;
    const int s = (row / n_heads) % sq;
    const int b = row / n_heads / sq;
    delta[((size_t)b * n_heads + h) * sq + s] = acc;
  }
}

// -- bfloat16: TMA + wgmma -------------------------------------------------------

constexpr int BQ = 64;                    // query rows a step
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int BTHREADS = CONSUMERS + 128; // and a producer warpgroup
constexpr int STAT_FLOATS = 3 * BQ;       // a query tile's packed statistics

// The tiles of head widths D (q, k, dq, dk) and DV (v, o, dO, dv), each
// read in column chunks (W of D, WV of DV; hopper.cuh, tma_map.cuh).  A
// block holds BK keys: 128, 64 for each consumer warpgroup, which sums dK
// and dV of its keys; or, where those two sums of 64 keys would not fit a
// thread's registers beside S and dP (D + DV past 256: the pairs (160,
// 160), (192, 192), (256, 256) and (192, 128)), 64 keys that both
// warpgroups share, warpgroup 0 summing dV and warpgroup 1 dK (SPLIT).
// Shared memory: the K and V tiles, dS^T of the step in two buffers of two
// bf16 terms (each the staging of a step's dQ once read), and a ring of
// STAGES Q / dO tiles with their rows' statistics.  dQ is taken in PASSES
// column chunks of W, the first PASSES0 by warpgroup 0, the rest by
// warpgroup 1.
template <int D, int DV>
struct BwdTile {
  static constexpr bool SPLIT = D + DV > 256;
  static constexpr int BK = SPLIT ? 64 : 128;
  static constexpr int W = chunk_of(D);
  static constexpr int WV = chunk_of(DV);
  static constexpr uint32_t MODE = pandadb::wgmma_swizzle(2 * W);
  static constexpr uint32_t SBO = 8 * 2 * W;   // bytes between 8-row groups
  static constexpr uint32_t MODE_V = pandadb::wgmma_swizzle(2 * WV);
  static constexpr uint32_t SBO_V = 8 * 2 * WV;
  static constexpr int KV_BYTES = BK * (D + DV) * 2;
  static constexpr int DS_ELEMS = BK * BQ;     // one bf16 term of dS^T
  static constexpr int STAGE_BYTES = BQ * (D + DV) * 2 + STAT_FLOATS * 4;
  static constexpr int FIXED = KV_BYTES + 4 * DS_ELEMS * 2;
  static constexpr int FIT = (SMEM_MAX - 1024 - FIXED) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 3 ? FIT : 3;
  static constexpr int SMEM = FIXED + STAGES * STAGE_BYTES;
  static constexpr int PASSES = D / W;
  static constexpr int PASSES0 = (PASSES + 1) / 2;
  // without SPLIT, dQ's float32 sums of a step ([BQ, D], at most the
  // 32 KB of a dS^T buffer) are staged in column chunks of CW floats
  static constexpr int CW = D < 32 ? D : 32;
  static_assert(STAGES >= 2, "two stages at least");
};

// The query tiles a key tile meets, for each query head of its group: the
// tiles holding rows that see no key (causal, Sq > Skv), then the tiles
// from the first that sees one of its keys (causal) to the last.  Step i
// of a block is tile tile(i % per_head) of its group's query head
// i / per_head.
struct Walk {
  int n_blind, first, per_head;
  __device__ Walk(int key0, int sq, int skv, int causal) {
    const int off = skv - sq;                 // query row i at i + off
    const int n_qt = (sq + BQ - 1) / BQ;
    n_blind = causal && off < 0 ? (min(sq, -off) + BQ - 1) / BQ : 0;
    first = max(n_blind, causal ? max(0, key0 - off) / BQ : 0);
    per_head = n_blind + n_qt - first;
  }
  __device__ int tile(int t) const {
    return t < n_blind ? t : first + t - n_blind;
  }
};

// D[64 x N] += A[64 x 16] B[16 x N], A in registers, B N-major in shared
// memory (hopper.cuh), N a compiled head width
template <int N>
__device__ __forceinline__ void rs_mma(float* d, const uint32_t* a,
                                       uint64_t db) {
  if constexpr (N == 16) pandadb::wgmma_rs_n16(d, a, db, 1);
  if constexpr (N == 32) pandadb::wgmma_rs_n32(d, a, db, 1);
  if constexpr (N == 64) pandadb::wgmma_rs_n64(d, a, db, 1);
  if constexpr (N == 128) pandadb::wgmma_rs_n128(d, a, db, 1);
  if constexpr (N == 160) pandadb::wgmma_rs_n160(d, a, db, 1);
  if constexpr (N == 192) pandadb::wgmma_rs_n192(d, a, db, 1);
  if constexpr (N == 256) pandadb::wgmma_rs_n256(d, a, db, 1);
}

// D[64 x N] += A[64 x 16] B[16 x N], both in shared memory, MN-major
// where TA, TB say so (hopper.cuh)
template <int N, int TA, int TB>
__device__ __forceinline__ void ss_mma(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 16) pandadb::wgmma_ss_n16<TA, TB>(d, da, db, 1);
  if constexpr (N == 32) pandadb::wgmma_ss_n32<TA, TB>(d, da, db, 1);
  if constexpr (N == 64) pandadb::wgmma_ss_n64<TA, TB>(d, da, db, 1);
  if constexpr (N == 128) pandadb::wgmma_ss_n128<TA, TB>(d, da, db, 1);
}

// X^T[64 x 64] = A[64 x W] B[64 x W]^T over the whole width, both operands
// K-major chunked tiles in shared memory: a the first of the 64 rows in
// chunk 0 of a tile of a_rows rows, b chunk 0 of a 64-row tile
template <int WIDTH, int W, uint32_t SBO, uint32_t MODE>
__device__ __forceinline__ void abt_mma(float* x, const bf16* a, int a_rows,
                                        const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < WIDTH / 16; ++kk) {
    const int c = kk * 16 / W, o = kk * 16 % W;
    pandadb::wgmma_ss_n64(x, wgmma_desc(a + c * a_rows * W + o, 16, SBO, MODE),
                          wgmma_desc(b + c * BQ * W + o, 16, SBO, MODE), 1);
  }
}

// bytes into a [rows][64] bf16 tile swizzled over 128 bytes (dS^T) of the
// pair at (row, column 8 n + 2 t4)
__device__ __forceinline__ int ds_at(int row, int n, int t4) {
  return row * 128 + ((n ^ (row & 7)) << 4) + t4 * 4;
}

// One consumer warpgroup's walk over a block's steps.  Without SPLIT,
// warpgroup ROLE owns the tile's keys [64 ROLE, 64 ROLE + 64) and sums dK
// and dV for them; with SPLIT both hold all 64 keys, ROLE 0 summing dV and
// ROLE 1 dK.  Per step, each product once on wgmma: S^T = K Q^T and
// dP^T = V dO^T (A and B K-major in shared memory), P and dS formed in
// registers, dS^T stored once to shared memory, dV += P^T dO (A from
// registers, B N-major) and dK += dS^T Q (A from the stored dS^T, or from
// registers with SPLIT), and, after the two warpgroups meet, this
// warpgroup's column chunks of dQ = dS K (A and B MN-major) added to
// dq_accum.  No wgmma sits under a run-time branch: a step whose keys cross
// the diagonal or Skv is masked element by element.
template <int D, int DV, int ROLE>
__device__ __forceinline__ void consume(
    const bf16* ks, const bf16* vs, bf16* dss, const bf16* qs,
    const bf16* dos, const float* sts, uint64_t* full, uint64_t* empty,
    uint64_t* kv_full, const CUtensorMap* dq_map,
    float* __restrict__ dq_accum, bf16* __restrict__ dk,
    bf16* __restrict__ dv, const Walk& walk, int n_steps, int key0, int kh,
    int b, int sq, int skv, int n_heads, int n_kv_heads, float scale,
    int causal) {
  using T = BwdTile<D, DV>;
  constexpr int ST = T::STAGES;
  constexpr int W = T::W, WV = T::WV, BK = T::BK;
  constexpr bool DO_DV = !T::SPLIT || ROLE == 0;
  constexpr bool DO_DK = !T::SPLIT || ROLE == 1;
  constexpr int KROW = T::SPLIT ? 0 : 64 * ROLE;   // the first key row held
  constexpr int PASS0 = ROLE == 0 ? 0 : T::PASSES0;
  constexpr int PASS1 = ROLE == 0 ? T::PASSES0 : T::PASSES;
  constexpr int NV = DO_DV ? DV / 2 : 1;   // accumulators a thread
  constexpr int NK = DO_DK ? D / 2 : 1;

  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, gr = lane / 4, t4 = lane % 4;
  const int kr0 = KROW + warp * 16 + gr;        // the thread's key rows
  const int g = n_heads / n_kv_heads;
  const int off = skv - sq;
  const float scale_log2 = scale * LOG2E;
  const int kw0 = key0 + KROW;                   // the warpgroup's first key
  const bool ragged = kw0 + 64 > skv;

  float dva[NV], dka[NK];
#pragma unroll
  for (int i = 0; i < NV; ++i) dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NK; ++i) dka[i] = 0.f;

  pandadb::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_steps; ++it) {
    const int s = it % ST;
    const int h = kh * g + it / walk.per_head;
    const int row0 = walk.tile(it % walk.per_head) * BQ;
    const bf16* qt = qs + s * BQ * D;
    const bf16* dot = dos + s * BQ * DV;
    const float* st = sts + s * STAT_FLOATS;   // m2, 1 / l, D of the rows
    bf16* dsh = dss + (it & 1) * 2 * T::DS_ELEMS;
    bf16* dsl = dsh + T::DS_ELEMS;
    pandadb::mbar_wait(&full[s], (it / ST) & 1);

    // S^T and dP^T: rows are the warpgroup's keys, columns the step's
    // query rows (column 8 n + 2 t4 + (e & 1) of element 4 n + e)
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    pandadb::wgmma_fence();
    abt_mma<D, W, T::SBO, T::MODE>(sc, ks + KROW * W, BK, qt);
    pandadb::wgmma_commit();
    if constexpr (DO_DK) {
      abt_mma<DV, WV, T::SBO_V, T::MODE_V>(dp, vs + KROW * WV, BK, dot);
      pandadb::wgmma_commit();
      pandadb::wgmma_wait<1>();
    } else {
      pandadb::wgmma_wait<0>();
    }
    pandadb::fence_regs<32>(sc);

    // P = exp(s - m) / l; a masked pair weighs 1 / l in a row that sees no
    // key (stored negated) and nothing elsewhere; keys past Skv nothing
    const bool masked = ragged || (causal && kw0 + 63 > row0 + off);
    if (!masked) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * t4;
        const float2 m2 = *reinterpret_cast<const float2*>(st + c);
        const float2 il = *reinterpret_cast<const float2*>(st + BQ + c);
        sc[4 * n] = exp2_ftz(fmaf(sc[4 * n], scale_log2, -m2.x)) * il.x;
        sc[4 * n + 1] = exp2_ftz(fmaf(sc[4 * n + 1], scale_log2, -m2.y)) * il.y;
        sc[4 * n + 2] = exp2_ftz(fmaf(sc[4 * n + 2], scale_log2, -m2.x)) * il.x;
        sc[4 * n + 3] = exp2_ftz(fmaf(sc[4 * n + 3], scale_log2, -m2.y)) * il.y;
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t4 + (e & 1);
          const int key = key0 + kr0 + (e >= 2 ? 8 : 0);
          const float il = st[BQ + c];
          sc[4 * n + e] =
              key >= skv ? 0.f
              : causal && key > row0 + c + off
                  ? fmaxf(-il, 0.f)
                  : exp2_ftz(fmaf(sc[4 * n + e], scale_log2, -st[c])) * il;
        }
      }
    }
    // dS = P (dP - D), zero where the mask replaced the score, stored as
    // dS^T in bf16 hi + lo for dK and dQ (kept in registers for dK with
    // SPLIT)
    uint32_t sh[4][4], sl[4][4];
    if constexpr (DO_DK) {
      pandadb::wgmma_wait<0>();
      pandadb::fence_regs<32>(dp);
      if (!masked) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 dd =
              *reinterpret_cast<const float2*>(st + 2 * BQ + 8 * n + 2 * t4);
          dp[4 * n] = sc[4 * n] * (dp[4 * n] - dd.x);
          dp[4 * n + 1] = sc[4 * n + 1] * (dp[4 * n + 1] - dd.y);
          dp[4 * n + 2] = sc[4 * n + 2] * (dp[4 * n + 2] - dd.x);
          dp[4 * n + 3] = sc[4 * n + 3] * (dp[4 * n + 3] - dd.y);
        }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * n + 2 * t4 + (e & 1);
            const int key = key0 + kr0 + (e >= 2 ? 8 : 0);
            const bool cut = key >= skv || (causal && key > row0 + c + off);
            dp[4 * n + e] =
                cut ? 0.f : sc[4 * n + e] * (dp[4 * n + e] - st[2 * BQ + c]);
          }
        }
      }
      char* hb = reinterpret_cast<char*>(dsh);
      char* lb = reinterpret_cast<char*>(dsl);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = dp[8 * j + 2 * r], x1 = dp[8 * j + 2 * r + 1];
          sh[j][r] = pack_bf16(x0, x1);
          sl[j][r] = pack_rest(x0, x1, sh[j][r]);
          const int at = ds_at(kr0 + (r & 1) * 8, 2 * j + (r >> 1), t4);
          *reinterpret_cast<uint32_t*>(hb + at) = sh[j][r];
          *reinterpret_cast<uint32_t*>(lb + at) = sl[j][r];
        }
      pandadb::fence_proxy_async();
    }

    // P^T as the A operand of dV (keys 16 j .. 16 j + 15 of the columns are
    // accumulator blocks 2 j, 2 j + 1), packed once dS no longer needs P
    uint32_t ph[4][4], pl[4][4];
    if constexpr (DO_DV) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ph[j][r] = pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
          pl[j][r] = pack_rest(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1],
                               ph[j][r]);
        }
    }

    // dV += P^T dO and dK += dS^T Q, 16 query rows a k-step.  Without
    // SPLIT, dK reads dS^T where it was just stored (A K-major in shared
    // memory, once this warpgroup's rows are all there), so no register
    // holds dS past the store.
    if constexpr (DO_DK && !T::SPLIT)
      pandadb::named_bar_sync(2 + ROLE, 128);
    pandadb::fence_regs<NV>(dva);
    pandadb::fence_regs<NK>(dka);
    pandadb::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (DO_DV) {
        const uint64_t d = wgmma_desc(dot + j * 16 * WV, 2 * BQ * WV,
                                      T::SBO_V, T::MODE_V);
        rs_mma<DV>(dva, ph[j], d);
        rs_mma<DV>(dva, pl[j], d);
      }
      if constexpr (DO_DK) {
        const uint64_t d = wgmma_desc(qt + j * 16 * W, 2 * BQ * W, T::SBO,
                                      T::MODE);
        if constexpr (T::SPLIT) {
          rs_mma<D>(dka, sh[j], d);
          rs_mma<D>(dka, sl[j], d);
        } else {
          const int at = KROW * BQ + j * 16;   // row KROW, column 16 j
          ss_mma<D, 0, 1>(dka, wgmma_desc(dsh + at, 16, 8 * 128, 1), d);
          ss_mma<D, 0, 1>(dka, wgmma_desc(dsl + at, 16, 8 * 128, 1), d);
        }
      }
    }
    pandadb::wgmma_commit();
    pandadb::named_bar_sync(1, CONSUMERS);     // every dS^T row is stored
    pandadb::wgmma_wait<0>();
    pandadb::fence_regs<NV>(dva);
    pandadb::fence_regs<NK>(dka);
    pandadb::mbar_arrive(&empty[s]);           // the stage is read

    // dQ = dS K over the tile's BK keys, one chunk of W columns a pass
    const int r0 = warp * 16 + gr;               // the thread's two rows
    float qa[W / 2];
    auto dq_pass = [&](int c) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) qa[i] = 0.f;
      pandadb::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t b_desc = wgmma_desc(ks + c * BK * W + kk * 16 * W,
                                           2 * BK * W, T::SBO, T::MODE);
        ss_mma<W, 1, 1>(qa, wgmma_desc(dsh + kk * 16 * BQ, 2 * BK * BQ,
                                       8 * 128, 1), b_desc);
        ss_mma<W, 1, 1>(qa, wgmma_desc(dsl + kk * 16 * BQ, 2 * BK * BQ,
                                       8 * 128, 1), b_desc);
      }
      pandadb::wgmma_commit();
      pandadb::wgmma_wait<0>();
      pandadb::fence_regs<W / 2>(qa);
    };
    if constexpr (T::SPLIT) {
      // added to dq_accum by vector atomics, a pass at a time
      float* q0p = dq_accum + (((size_t)b * sq + row0 + r0) * n_heads + h) * D;
      float* q1p = q0p + (size_t)8 * n_heads * D;
#pragma unroll
      for (int c = PASS0; c < PASS1; ++c) {
        dq_pass(c);
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
          const int col = c * W + 8 * n + 2 * t4;
          if (row0 + r0 < sq)
            pandadb::red_add2(q0p + col, qa[4 * n], qa[4 * n + 1]);
          if (row0 + r0 + 8 < sq)
            pandadb::red_add2(q1p + col, qa[4 * n + 2], qa[4 * n + 3]);
        }
      }
    } else {
      // staged in this step's dS^T buffer once both warpgroups' products
      // have read it ([D / CW][BQ][CW] float32, swizzled as the TMA unit
      // reads it), then added to dq_accum by one TMA reduction; the last
      // step's reduction has read its buffer before anyone passes here
      if constexpr (PASS1 > PASS0) dq_pass(PASS0);
      if (threadIdx.x == 0) pandadb::bulk_wait_read<0>();
      pandadb::named_bar_sync(3, CONSUMERS);
      char* stage = reinterpret_cast<char*>(dsh);
      if constexpr (PASS1 > PASS0) {
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
          const int col = PASS0 * W + 8 * n + 2 * t4;
          char* chunk = stage + col / T::CW * BQ * T::CW * 4;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            int at = (r0 + 8 * half) * T::CW * 4 + col % T::CW * 4;
            at ^= ((at >> 7) & (T::CW / 4 - 1)) << 4;
            *reinterpret_cast<float2*>(chunk + at) =
                make_float2(qa[4 * n + 2 * half], qa[4 * n + 2 * half + 1]);
          }
        }
      }
      pandadb::fence_proxy_async();
      pandadb::named_bar_sync(4, CONSUMERS);
      if (threadIdx.x == 0) {
        pandadb::tma_reduce_add_5d(dq_map, stage, 0, row0, 0, h, b);
        pandadb::bulk_commit();
      }
    }
  }
  if constexpr (!T::SPLIT)
    if (threadIdx.x == 0) pandadb::bulk_wait<0>();

  // dK (times the scale) and dV of the held keys, written once
  const int k0 = key0 + kr0, k1 = k0 + 8;
  const size_t kv_row = ((size_t)b * skv + k0) * n_kv_heads + kh;
  const size_t eight = (size_t)8 * n_kv_heads;
  if constexpr (DO_DV) {
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      if (k0 < skv)
        *reinterpret_cast<uint32_t*>(dv + kv_row * DV + c) =
            pack_bf16(dva[4 * n], dva[4 * n + 1]);
      if (k1 < skv)
        *reinterpret_cast<uint32_t*>(dv + (kv_row + eight) * DV + c) =
            pack_bf16(dva[4 * n + 2], dva[4 * n + 3]);
    }
  }
  if constexpr (DO_DK) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      if (k0 < skv)
        *reinterpret_cast<uint32_t*>(dk + kv_row * D + c) =
            pack_bf16(dka[4 * n] * scale, dka[4 * n + 1] * scale);
      if (k1 < skv)
        *reinterpret_cast<uint32_t*>(dk + (kv_row + eight) * D + c) =
            pack_bf16(dka[4 * n + 2] * scale, dka[4 * n + 3] * scale);
    }
  }
}

// q, dO [B, Sq, H, D or DV], k, v [B, Skv, KVH, D or DV] reach the kernel as
// TMA tensor maps (tma_map.cuh); stats [B, H, n_qt, 3, BQ] from
// bwd_pack_stats; dq_accum [B, Sq, H, D] float32, zeroed, takes dQ / scale
// by atomics.  One block per (KVH, B, key tile), the heaviest key tiles
// (first under causal, seen by every later row) launched first.
template <int D, int DV>
__global__ void __launch_bounds__(BTHREADS, 1)
flash_bwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap dq_map,
                const float* __restrict__ stats, float* __restrict__ dq_accum,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int skv,
                int n_heads, int n_kv_heads, float scale, int causal) {
  using T = BwdTile<D, DV>;
  constexpr int ST = T::STAGES;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[ST], empty[ST], kv_full;
  bf16* ks = reinterpret_cast<bf16*>(smem);     // [BK] keys, chunked
  bf16* vs = ks + T::BK * D;
  bf16* dss = vs + T::BK * DV;                  // [2][hi, lo][BK][BQ]
  bf16* qs = dss + 4 * T::DS_ELEMS;             // [ST] Q tiles
  bf16* dos = qs + ST * BQ * D;                 // [ST] dO tiles
  float* sts = reinterpret_cast<float*>(dos + ST * BQ * DV);

  const int kh = blockIdx.x, b = blockIdx.y;
  const int key0 = blockIdx.z * T::BK;
  const int g = n_heads / n_kv_heads;
  const int n_qt = (sq + BQ - 1) / BQ;
  const Walk walk(key0, sq, skv, causal);
  const int n_steps = g * walk.per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      pandadb::mbar_init(&full[s], 1);
      pandadb::mbar_init(&empty[s], CONSUMERS);
    }
    pandadb::mbar_init(&kv_full, 1);
    pandadb::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer warpgroup gives its registers to the consumers; one
    // thread loads K and V once and keeps ST steps' Q, dO and statistics
    // in flight, each stage refilled once both consumers release it
    pandadb::regs_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      pandadb::mbar_expect_tx(&kv_full, T::KV_BYTES);
      pandadb::tma_load_5d(ks, &k_map, &kv_full, 0, key0, 0, kh, b);
      pandadb::tma_load_5d(vs, &v_map, &kv_full, 0, key0, 0, kh, b);
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % ST;
        if (it >= ST) pandadb::mbar_wait(&empty[s], (it / ST - 1) & 1);
        const int h = kh * g + it / walk.per_head;
        const int tile = walk.tile(it % walk.per_head);
        pandadb::mbar_expect_tx(&full[s], T::STAGE_BYTES);
        pandadb::tma_load_5d(qs + s * BQ * D, &q_map, &full[s], 0, tile * BQ,
                             0, h, b);
        pandadb::tma_load_5d(dos + s * BQ * DV, &do_map, &full[s], 0,
                             tile * BQ, 0, h, b);
        pandadb::bulk_load(
            sts + s * STAT_FLOATS,
            stats + ((size_t)(b * n_heads + h) * n_qt + tile) * STAT_FLOATS,
            STAT_FLOATS * 4, &full[s]);
      }
    }
    return;
  }
  pandadb::regs_inc<240>();
  if (threadIdx.x < 128)
    consume<D, DV, 0>(ks, vs, dss, qs, dos, sts, full, empty, &kv_full,
                      &dq_map, dq_accum, dk, dv, walk, n_steps, key0, kh, b, sq, skv,
                      n_heads, n_kv_heads, scale, causal);
  else
    consume<D, DV, 1>(ks, vs, dss, qs, dos, sts, full, empty, &kv_full,
                      &dq_map, dq_accum, dk, dv, walk, n_steps, key0, kh, b, sq, skv,
                      n_heads, n_kv_heads, scale, causal);
}

// Each query tile's row statistics as the wgmma kernel reads them, [B, H,
// n_qt, 3, BQ]: m in base 2, 1 / l (negated for a row that sees no key,
// whose masked weights are 1 / l) and D; rows past Sq all zero, so they
// weigh nothing.  One thread a row.
__global__ void bwd_pack_stats(const float* __restrict__ m,
                               const float* __restrict__ l,
                               const float* __restrict__ delta,
                               float* __restrict__ stats, int n_rows, int sq,
                               int n_qt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const int r = i % BQ;
  const int tile = i / BQ % n_qt;
  const size_t bh = (size_t)(i / BQ / n_qt);
  const int row = tile * BQ + r;
  const RowStats st = row_stats(m, l, delta, bh * sq + row, row < sq);
  float* out = stats + (bh * n_qt + tile) * STAT_FLOATS;
  out[r] = st.m2;
  out[BQ + r] = st.blind ? -st.il : st.il;
  out[2 * BQ + r] = st.dd;
}

// dq = scale dq_accum in bf16, eight values a thread
__global__ void bwd_dq_cast(const float4* __restrict__ acc,
                            uint4* __restrict__ dq, size_t n8, float scale) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float4 a = acc[2 * i], c = acc[2 * i + 1];
  dq[i] = make_uint4(pack_bf16(a.x * scale, a.y * scale),
                     pack_bf16(a.z * scale, a.w * scale),
                     pack_bf16(c.x * scale, c.y * scale),
                     pack_bf16(c.z * scale, c.w * scale));
}

// -- float32: SIMT ---------------------------------------------------------------

constexpr int FL = 8;                  // threads a row
constexpr int FROWS = 32;              // rows (keys or queries) a block
constexpr int FTHREADS = FL * FROWS;   // 256

// rows staged a step in shared memory: 32, or 16 where 32 rows of both
// widths would pass the 40 KB the static tiles may take
template <int D, int DV>
constexpr int F32_STAGE = 32 * (D + DV) * 4 <= 40960 ? 32 : 16;

// a row's dot over the FL threads that hold it
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int w = 1; w < FL; w *= 2) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

// [rows, W] float32 rows r0.. of a [seq, heads, W] slice into shared memory
template <int W>
__device__ __forceinline__ void load_rows_f32(float* dst,
                                              const float* __restrict__ src,
                                              int r0, int rows, int seq,
                                              int heads) {
  for (int e = threadIdx.x; e < rows * W; e += FTHREADS) {
    const int r = e / W, c = e % W;
    dst[e] = r0 + r < seq ? src[(size_t)(r0 + r) * heads * W + c] : 0.f;
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ m, const float* __restrict__ l,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int sq, int skv, int n_heads,
                   int n_kv_heads, float scale, int causal) {
  constexpr int C = D / FL, CV = DV / FL;
  constexpr int RS = F32_STAGE<D, DV>;
  __shared__ float qs[RS][D];
  __shared__ float dos[RS][DV];
  __shared__ float sm2[RS], sil[RS], sdd[RS];
  __shared__ unsigned char sblind[RS];

  const int kh = blockIdx.y, b = blockIdx.z;
  const int key0 = blockIdx.x * FROWS;
  const int key = key0 + threadIdx.x / FL;
  const int lane = threadIdx.x % FL;
  const int g = n_heads / n_kv_heads;
  const int off = skv - sq;
  const float scale_log2 = scale * LOG2E;

  float kr[C], vr[CV], dka[C], dva[CV];
  const size_t kv_row = ((size_t)b * skv + key) * n_kv_heads + kh;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    kr[c] = key < skv ? k[kv_row * D + lane + FL * c] : 0.f;
    dka[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < CV; ++c) {
    vr[c] = key < skv ? v[kv_row * DV + lane + FL * c] : 0.f;
    dva[c] = 0.f;
  }
  const int first = causal ? max(0, key0 - off) / RS * RS : 0;
  const int blind_end = causal && off < 0 ? min(sq, -off) : 0;

  for (int j = 0; j < g; ++j) {
    const int h = kh * g + j;
    const size_t st0 = ((size_t)b * n_heads + h) * sq;
    for (int row0 = 0; row0 < sq; row0 += RS) {
      if (row0 >= blind_end && row0 + RS <= first) continue;
      __syncthreads();
      load_rows_f32<D>(&qs[0][0], q + ((size_t)b * sq * n_heads + h) * D, row0,
                       RS, sq, n_heads);
      load_rows_f32<DV>(&dos[0][0],
                        dout + ((size_t)b * sq * n_heads + h) * DV, row0, RS,
                        sq, n_heads);
      if (threadIdx.x < RS) {
        const int r = threadIdx.x;
        const RowStats st = row_stats(m, l, delta, st0 + row0 + r,
                                      row0 + r < sq);
        sm2[r] = st.m2;
        sil[r] = st.il;
        sdd[r] = st.dd;
        sblind[r] = st.blind;
      }
      __syncthreads();
      for (int r = 0; r < RS; ++r) {
        float sp = 0.f, dpp = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) sp += kr[c] * qs[r][lane + FL * c];
#pragma unroll
        for (int c = 0; c < CV; ++c) dpp += vr[c] * dos[r][lane + FL * c];
        sp = row_sum(sp);
        dpp = row_sum(dpp);
        const bool masked = causal && key > row0 + r + off;
        const RowStats st{sm2[r], sil[r], sdd[r], sblind[r] != 0};
        const float p = weight(sp, scale_log2, st, masked);
        const float ds = masked ? 0.f : p * (dpp - st.dd);
#pragma unroll
        for (int c = 0; c < CV; ++c) dva[c] += p * dos[r][lane + FL * c];
#pragma unroll
        for (int c = 0; c < C; ++c) dka[c] += ds * qs[r][lane + FL * c];
      }
    }
  }
  if (key >= skv) return;
#pragma unroll
  for (int c = 0; c < C; ++c) dk[kv_row * D + lane + FL * c] = dka[c] * scale;
#pragma unroll
  for (int c = 0; c < CV; ++c) dv[kv_row * DV + lane + FL * c] = dva[c];
}

template <int D, int DV>
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ m, const float* __restrict__ l,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int sq, int skv, int n_heads, int n_kv_heads, float scale,
                 int causal) {
  constexpr int C = D / FL, CV = DV / FL;
  constexpr int KS = F32_STAGE<D, DV>;
  __shared__ float ks[KS][D];
  __shared__ float vs[KS][DV];

  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (n_heads / n_kv_heads);
  const int q0 = qt * FROWS;
  const int row = q0 + threadIdx.x / FL;
  const int lane = threadIdx.x % FL;
  const int off = skv - sq;
  const float scale_log2 = scale * LOG2E;
  const bool live = row < sq;

  float qr[C], dor[CV], dqa[C];
  const size_t q_row = ((size_t)b * sq + row) * n_heads + h;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qr[c] = live ? q[q_row * D + lane + FL * c] : 0.f;
    dqa[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < CV; ++c)
    dor[c] = live ? dout[q_row * DV + lane + FL * c] : 0.f;
  const RowStats st = row_stats(m, l, delta,
                                ((size_t)b * n_heads + h) * sq + row, live);
  const int last = min(q0 + FROWS, sq) - 1;
  const int k_end = causal ? min(skv, max(0, last + off + 1)) : skv;

  for (int c0 = 0; c0 < k_end; c0 += KS) {
    __syncthreads();
    load_rows_f32<D>(&ks[0][0], k + ((size_t)b * skv * n_kv_heads + kh) * D,
                     c0, KS, skv, n_kv_heads);
    load_rows_f32<DV>(&vs[0][0], v + ((size_t)b * skv * n_kv_heads + kh) * DV,
                      c0, KS, skv, n_kv_heads);
    __syncthreads();
    for (int j = 0; j < KS; ++j) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) sp += qr[c] * ks[j][lane + FL * c];
#pragma unroll
      for (int c = 0; c < CV; ++c) dpp += dor[c] * vs[j][lane + FL * c];
      sp = row_sum(sp);
      dpp = row_sum(dpp);
      const int key = c0 + j;
      const bool masked = key >= skv || (causal && key > row + off);
      const float p = weight(sp, scale_log2, st, masked);
      const float ds = masked ? 0.f : p * (dpp - st.dd);
#pragma unroll
      for (int c = 0; c < C; ++c) dqa[c] += ds * ks[j][lane + FL * c];
    }
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < C; ++c) dq[q_row * D + lane + FL * c] = dqa[c] * scale;
}

// The compiled (D, DV) pairs: those of flash_attention.cu.
#define PANDADB_FLASH_PAIRS(X)                                                \
  X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(160, 160) X(192, 192)           \
  X(256, 256) X(192, 128)

template <int D, int DV>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v,
                 const bf16* dout, const float* m, const float* l,
                 const float* delta, float* stats, float* dq_accum, bf16* dq,
                 bf16* dk, bf16* dv, int n_b, int sq, int skv, int n_heads,
                 int n_kv_heads, float scale, int causal, cudaStream_t st) {
  using T = BwdTile<D, DV>;
  const int n_qt = (sq + BQ - 1) / BQ;
  const long n_rows = (long)n_b * n_heads * n_qt * BQ;
  const long n_kt = (skv + T::BK - 1) / T::BK;
  if (n_rows > 0x7fffffffL || n_kt > MAX_GRID)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, dom, dqm{};     // dqm: without SPLIT only
  int err = make_map(&qm, q, n_b, sq, n_heads, D, T::W, BQ);
  if (err == 0) err = make_map(&km, k, n_b, skv, n_kv_heads, D, T::W, T::BK);
  if (err == 0)
    err = make_map(&vm, v, n_b, skv, n_kv_heads, DV, T::WV, T::BK);
  if (err == 0) err = make_map(&dom, dout, n_b, sq, n_heads, DV, T::WV, BQ);
  if (err == 0 && !T::SPLIT)
    err = pandadb::make_map_of(&dqm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                               dq_accum, n_b, sq, n_heads, D, T::CW, BQ);
  if (err != 0) return err;
  static bool ready = false;      // shared memory past 48 KB, asked for once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_wgmma<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  bwd_pack_stats<<<(unsigned)((n_rows + 255) / 256), 256, 0, st>>>(
      m, l, delta, stats, (int)n_rows, sq, n_qt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_wgmma<D, DV><<<dim3(n_kv_heads, n_b, (unsigned)n_kt), BTHREADS,
                           T::SMEM, st>>>(qm, km, vm, dom, dqm, stats,
                                          dq_accum, dk,
                                          dv, sq, skv, n_heads, n_kv_heads,
                                          scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n8 = (size_t)n_b * sq * n_heads * D / 8;
  bwd_dq_cast<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(dq_accum), reinterpret_cast<uint4*>(dq),
      n8, scale);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_f32(const float* q, const float* k, const float* v,
               const float* dout, const float* m, const float* l,
               const float* delta, float* dq, float* dk, float* dv, int n_b,
               int sq, int skv, int n_heads, int n_kv_heads, float scale,
               int causal, cudaStream_t st) {
  const dim3 gkv((skv + FROWS - 1) / FROWS, n_kv_heads, n_b);
  flash_bwd_dkdv_f32<D, DV><<<gkv, FTHREADS, 0, st>>>(
      q, k, v, dout, m, l, delta, dk, dv, sq, skv, n_heads, n_kv_heads, scale,
      causal);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 gq((sq + FROWS - 1) / FROWS, n_heads, n_b);
  flash_bwd_dq_f32<D, DV><<<gq, FTHREADS, 0, st>>>(
      q, k, v, dout, m, l, delta, dq, sq, skv, n_heads, n_kv_heads, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_delta(const T* o, const T* dout, float* delta, int n_b, int sq,
                 int n_heads, int dv, cudaStream_t st) {
  const long rows = (long)n_b * sq * n_heads;
  const long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  bwd_delta<T><<<(unsigned)blocks, 256, 0, st>>>(o, dout, delta, (int)rows,
                                                 sq, n_heads, dv);
  return (int)cudaGetLastError();
}

}  // namespace

// q [n_b, sq, n_heads, d], k [n_b, skv, n_kv_heads, d], v [n_b, skv,
// n_kv_heads, dv], o and dout [n_b, sq, n_heads, dv], all contiguous, of
// type dtype (0 float32, 1 bfloat16; bfloat16 pointers 16-byte aligned);
// m, l [n_b, n_heads, sq] float32, the forward's row statistics; delta
// [n_b, n_heads, sq] float32 scratch; for bfloat16 also stats, float32
// scratch of n_b n_heads ceil(sq / q_rows) 3 q_rows floats
// (flash_attention_bwd_layout's q_rows), and dq_accum, float32 [n_b, sq,
// n_heads, d] set to zero (both null for float32); dq, dk, dv like q, k,
// v.  (d, dv) one of PANDADB_FLASH_PAIRS; skv >= 1.  Three launches
// (float32) or four (bfloat16) on `stream`; returns the first cudaError_t
// that is not success, or 10000 + the CUresult of a refused tensor map.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* m,
                                   const float* l, float* delta, float* stats,
                                   float* dq_accum, void* dq, void* dk,
                                   void* dv, int n_b, int sq, int skv,
                                   int n_heads, int n_kv_heads, int d,
                                   int dvw, int dtype, float scale,
                                   int causal, void* stream) {
  if (n_b <= 0 || sq <= 0) return 0;
  if (skv <= 0 || n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      n_heads > MAX_GRID || n_b > MAX_GRID)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == pandadb::DTYPE_F32) {
    const float* of = static_cast<const float*>(o);
    const float* df = static_cast<const float*>(dout);
    int err = launch_delta(of, df, delta, n_b, sq, n_heads, dvw, st);
    if (err != 0) return err;
#define PANDADB_BWD(DIM, DIMV)                                                \
  case DIM * 1000 + DIMV:                                                     \
    return launch_f32<DIM, DIMV>(                                             \
        static_cast<const float*>(q), static_cast<const float*>(k),           \
        static_cast<const float*>(v), df, m, l, delta,                        \
        static_cast<float*>(dq), static_cast<float*>(dk),                     \
        static_cast<float*>(dv), n_b, sq, skv, n_heads, n_kv_heads, scale,    \
        causal, st);
    switch (d * 1000 + dvw) {
      PANDADB_FLASH_PAIRS(PANDADB_BWD)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef PANDADB_BWD
  }
  if (dtype == pandadb::DTYPE_BF16) {
    const bf16* ob = static_cast<const bf16*>(o);
    const bf16* db = static_cast<const bf16*>(dout);
    int err = launch_delta(ob, db, delta, n_b, sq, n_heads, dvw, st);
    if (err != 0) return err;
#define PANDADB_BWD(DIM, DIMV)                                                \
  case DIM * 1000 + DIMV:                                                     \
    return launch_wgmma<DIM, DIMV>(                                           \
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),             \
        static_cast<const bf16*>(v), db, m, l, delta, stats, dq_accum,        \
        static_cast<bf16*>(dq), static_cast<bf16*>(dk),                       \
        static_cast<bf16*>(dv), n_b, sq, skv, n_heads, n_kv_heads, scale,     \
        causal, st);
    switch (d * 1000 + dvw) {
      PANDADB_FLASH_PAIRS(PANDADB_BWD)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef PANDADB_BWD
  }
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 kernel's layout at head widths (d, dv), into out[6]: keys a
// block, query rows a step (q_rows), stages of the Q / dO ring, dynamic
// shared memory bytes, threads a block, and 1 where the two consumer
// warpgroups split dK and dV over the same keys.  Returns 0, or
// cudaErrorInvalidValue for a pair not compiled.
extern "C" int flash_attention_bwd_layout(int d, int dv, int* out) {
#define PANDADB_BWD(DIM, DIMV)                                                \
  case DIM * 1000 + DIMV: {                                                   \
    using T = BwdTile<DIM, DIMV>;                                             \
    const int v[6] = {T::BK, BQ, T::STAGES, T::SMEM, BTHREADS, T::SPLIT};     \
    for (int i = 0; i < 6; ++i) out[i] = v[i];                                \
    return 0;                                                                 \
  }
  switch (d * 1000 + dv) {
    PANDADB_FLASH_PAIRS(PANDADB_BWD)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PANDADB_BWD
}
