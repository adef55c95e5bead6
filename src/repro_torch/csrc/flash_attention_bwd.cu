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
// (query, key) pairs: bound by operations at the prefill's shapes.  This
// first kernel is simple, not fast: three launches, deterministic, no
// atomics.
//
// 1. delta: D for every row, one warp a row.
// 2. dK/dV: one block per (key tile, key head, batch row), looping over the
//    G query heads and the query rows that the tile is visible to (and the
//    rows that see no key, which weigh every key).  No other block writes
//    its rows of dK and dV, so they are summed in registers over the whole
//    loop and written once.
// 3. dQ: one block per (query tile, head, batch row), looping over the key
//    tiles its rows see.
//
// bfloat16: the products on the tensor cores with mma.sync m16n8k16 (bf16
// operands, float32 sums; hopper.cuh), tiles in shared memory, operands
// loaded with ldmatrix.  bf16 products of bf16 inputs are exact in
// float32, so S and dP are float32-faithful.  P and dS are float32 and
// enter the products dV, dK and dQ as two bf16 terms, hi = bf16(x) and
// lo = bf16(x - hi) (16 bits of each value, as the forward's P V), so the
// gradients are those of the float32 arithmetic, rounded once to bf16.  In
// the dK/dV kernel the warps 0-3 sum dV and the warps 4-7 dK, 16 keys a
// warp, each recomputing S for its keys: the two accumulators of a 256-wide
// head would not fit one thread's registers beside each other.
// float32 (the parity configs): SIMT float32 FMAs, eight threads a row (a
// key in the dK/dV kernel, a query in the dQ kernel), each holding an
// eighth of the row's operands and sums in registers.
#include <cmath>

#include "attention_dtype.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using pandadb::ATTN_NEG;
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

// -- bfloat16: mma.sync ----------------------------------------------------------

// Tiles of head widths D (q, k) and DV (v, o): rows in shared memory padded
// by 8 bf16 (16 bytes), so the eight rows an ldmatrix reads fall in
// different banks.
template <int D, int DV>
struct BwdTile {
  static constexpr int BK = 64;      // keys of a dK/dV block (4 warps x 16)
  static constexpr int BQ = 32;      // query rows a step of its loop
  static constexpr int QT = 64;      // query rows of a dQ block (4 warps x 16)
  static constexpr int KC = 32;      // keys a step of its loop
  static constexpr int LD = D + 8;
  static constexpr int LDV = DV + 8;
  static constexpr int SMEM_KV = (BK + BQ) * (LD + LDV) * 2 + 4 * BQ * 4;
  static constexpr int SMEM_Q = (QT + KC) * (LD + LDV) * 2;
  static_assert(SMEM_KV <= SMEM_MAX && SMEM_Q <= SMEM_MAX, "tiles too wide");
};

// rows [r0, r0 + rows) of a [seq, heads, w] slice (head stride heads * w)
// into shared memory at stride ld, 16 bytes a thread; rows past seq zero
template <int W>
__device__ __forceinline__ void load_rows(bf16* dst, int ld,
                                          const bf16* __restrict__ src,
                                          int r0, int rows, int seq,
                                          int heads, int n_threads) {
  for (int e = threadIdx.x; e < rows * (W / 8); e += n_threads) {
    const int r = e / (W / 8), c = e % (W / 8) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < seq)
      x = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * heads * W +
                                          c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
  }
}

// C[16 x 8 NB] = A[16 x W] B^T for one warp: A rows a_rows (stride lda),
// B rows b_rows (stride ldb, 8 NB of them), both row-major over W in
// shared memory.  acc[n] is the n-th 16 x 8 block.
template <int W, int NB>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const bf16* a_rows,
                                        int lda, const bf16* b_rows,
                                        int ldb) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    uint32_t a[4];
    pandadb::ldmatrix_x4(a, a_rows + (lane % 16) * lda + kk * 16 +
                                (lane / 16) * 8);
#pragma unroll
    for (int n = 0; n < NB; n += 2) {
      uint32_t b[4];     // b[0..1]: block n, b[2..3]: block n + 1
      pandadb::ldmatrix_x4(b, b_rows + (8 * n + lane % 8 + 8 * (lane / 16)) *
                                           ldb + kk * 16 +
                                  8 * ((lane / 8) % 2));
      pandadb::mma_16816(acc[n], a, b);
      pandadb::mma_16816(acc[n + 1], a, b + 2);
    }
  }
}

// acc[16 x W] += X[16 x 16 KS] Y[16 KS x W] for one warp: X in registers as
// mma accumulator blocks x[2 KS][4] (float32, entered as hi + lo), Y rows
// row-major in shared memory (stride ldy).
template <int W, int KS>
__device__ __forceinline__ void mma_xy(float (*acc)[4], float (*x)[4],
                                       const bf16* y_rows, int ldy) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    uint32_t hi[4], lo[4];
    hi[0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
    hi[1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
    hi[2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    hi[3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
    lo[0] = pack_rest(x[2 * j][0], x[2 * j][1], hi[0]);
    lo[1] = pack_rest(x[2 * j][2], x[2 * j][3], hi[1]);
    lo[2] = pack_rest(x[2 * j + 1][0], x[2 * j + 1][1], hi[2]);
    lo[3] = pack_rest(x[2 * j + 1][2], x[2 * j + 1][3], hi[3]);
#pragma unroll
    for (int n = 0; n < W / 8; n += 2) {
      uint32_t b[4];
      pandadb::ldmatrix_x4_trans(b, y_rows + (16 * j + lane % 16) * ldy +
                                        8 * n + 8 * (lane / 16));
      pandadb::mma_16816(acc[n], hi, b);
      pandadb::mma_16816(acc[n + 1], hi, b + 2);
      pandadb::mma_16816(acc[n], lo, b);
      pandadb::mma_16816(acc[n + 1], lo, b + 2);
    }
  }
}

// rows of a warp's 16 x W accumulator (rows row0 + gr, + 8) to dst (row
// stride `stride`), times `mul`, rows past `limit` skipped
template <int W>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride,
                                           const float (*acc)[4], int row0,
                                           int limit, float mul) {
  const int lane = threadIdx.x % 32, gr = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    const int c = 8 * n + 2 * t4;
    if (row0 + gr < limit)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(row0 + gr) * stride + c) =
          pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    if (row0 + gr + 8 < limit)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(row0 + gr + 8) * stride +
                                   c) =
          pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// One warp's share of a dK/dV step: its 16 keys (kw within the tile)
// against the BQ query rows staged in shared memory.  DK: dK += dS^T q;
// else dV += P^T dO.
template <int D, int DV, bool DK>
__device__ __forceinline__ void dkdv_step(
    float (*acc)[4], const bf16* ks, const bf16* vs, const bf16* qs,
    const bf16* dos, const float* sm2, const float* sil, const float* sdd,
    const unsigned char* sblind, int kw, int key0, int row0, int off,
    float scale_log2, int causal) {
  using T = BwdTile<D, DV>;
  constexpr int NB = T::BQ / 8;
  const int lane = threadIdx.x % 32, gr = lane / 4, t4 = lane % 4;
  float s[NB][4];
  mma_abt<D, NB>(s, ks + kw * T::LD, T::LD, qs, T::LD);   // S^T = K q^T
  float dp[NB][4];
  if constexpr (DK)
    mma_abt<DV, NB>(dp, vs + kw * T::LDV, T::LDV, dos, T::LDV);  // V dO^T
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + kw + gr + (e >= 2 ? 8 : 0);
      const int r = 8 * n + 2 * t4 + (e & 1);              // staged row
      const bool masked = causal && key > row0 + r + off;
      const RowStats st{sm2[r], sil[r], sdd[r], sblind[r] != 0};
      const float p = weight(s[n][e], scale_log2, st, masked);
      if constexpr (DK)
        s[n][e] = masked ? 0.f : p * (dp[n][e] - st.dd);
      else
        s[n][e] = p;
    }
  }
  if constexpr (DK)
    mma_xy<D, T::BQ / 16>(acc, s, qs, T::LD);
  else
    mma_xy<DV, T::BQ / 16>(acc, s, dos, T::LDV);
}

template <int D, int DV>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ m, const float* __restrict__ l,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int sq, int skv, int n_heads,
                   int n_kv_heads, float scale, int causal) {
  using T = BwdTile<D, DV>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);      // [BK][LD]
  bf16* vs = ks + T::BK * T::LD;                 // [BK][LDV]
  bf16* qs = vs + T::BK * T::LDV;                // [BQ][LD]
  bf16* dos = qs + T::BQ * T::LD;                // [BQ][LDV]
  float* sm2 = reinterpret_cast<float*>(dos + T::BQ * T::LDV);
  float* sil = sm2 + T::BQ;
  float* sdd = sil + T::BQ;
  unsigned char* sblind = reinterpret_cast<unsigned char*>(sdd + T::BQ);

  const int kh = blockIdx.y, b = blockIdx.z;
  const int key0 = blockIdx.x * T::BK;
  const int g = n_heads / n_kv_heads;
  const int off = skv - sq;                       // query row i at i + off
  const int warp = threadIdx.x / 32;
  const bool dk_warp = warp >= 4;
  const int kw = warp % 4 * 16;
  const float scale_log2 = scale * LOG2E;

  load_rows<D>(ks, T::LD, k + ((size_t)b * skv * n_kv_heads + kh) * D, key0,
               T::BK, skv, n_kv_heads, 256);
  load_rows<DV>(vs, T::LDV, v + ((size_t)b * skv * n_kv_heads + kh) * DV,
                key0, T::BK, skv, n_kv_heads, 256);

  // the rows that see a key of the tile (causal: from key0 - off on), and
  // under causal the rows at negative positions, which weigh every key
  const int first = causal ? max(0, key0 - off) / T::BQ * T::BQ : 0;
  const int blind_end = causal && off < 0 ? min(sq, -off) : 0;

  float acc[(D > DV ? D : DV) / 8][4];
#pragma unroll
  for (int n = 0; n < (D > DV ? D : DV) / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < g; ++j) {
    const int h = kh * g + j;
    const size_t st0 = ((size_t)b * n_heads + h) * sq;
    for (int row0 = 0; row0 < sq; row0 += T::BQ) {
      if (row0 >= blind_end && row0 + T::BQ <= first) continue;
      __syncthreads();                            // the last step is read
      load_rows<D>(qs, T::LD, q + ((size_t)b * sq * n_heads + h) * D, row0,
                   T::BQ, sq, n_heads, 256);
      load_rows<DV>(dos, T::LDV, dout + ((size_t)b * sq * n_heads + h) * DV,
                    row0, T::BQ, sq, n_heads, 256);
      if (threadIdx.x < T::BQ) {
        const int r = threadIdx.x;
        const RowStats st = row_stats(m, l, delta, st0 + row0 + r,
                                      row0 + r < sq);
        sm2[r] = st.m2;
        sil[r] = st.il;
        sdd[r] = st.dd;
        sblind[r] = st.blind;
      }
      __syncthreads();
      if (dk_warp)
        dkdv_step<D, DV, true>(acc, ks, vs, qs, dos, sm2, sil, sdd, sblind,
                               kw, key0, row0, off, scale_log2, causal);
      else
        dkdv_step<D, DV, false>(acc, ks, vs, qs, dos, sm2, sil, sdd, sblind,
                                kw, key0, row0, off, scale_log2, causal);
    }
  }
  const size_t stride = (size_t)n_kv_heads;
  if (dk_warp)
    store_rows<D>(dk + ((size_t)b * skv * n_kv_heads + kh) * D, stride * D,
                  acc, key0 + kw, skv, scale);
  else
    store_rows<DV>(dv + ((size_t)b * skv * n_kv_heads + kh) * DV,
                   stride * DV, acc, key0 + kw, skv, 1.f);
}

template <int D, int DV>
__global__ void __launch_bounds__(128)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ m, const float* __restrict__ l,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int sq, int skv, int n_heads, int n_kv_heads, float scale,
                 int causal) {
  using T = BwdTile<D, DV>;
  constexpr int NB = T::KC / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);      // [QT][LD]
  bf16* dos = qs + T::QT * T::LD;                // [QT][LDV]
  bf16* ks = dos + T::QT * T::LDV;               // [KC][LD]
  bf16* vs = ks + T::KC * T::LD;                 // [KC][LDV]

  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (n_heads / n_kv_heads);
  const int q0 = qt * T::QT;
  const int off = skv - sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const int r0 = q0 + warp * 16 + gr;            // this thread's two rows
  const float scale_log2 = scale * LOG2E;

  load_rows<D>(qs, T::LD, q + ((size_t)b * sq * n_heads + h) * D, q0, T::QT,
               sq, n_heads, 128);
  load_rows<DV>(dos, T::LDV, dout + ((size_t)b * sq * n_heads + h) * DV, q0,
                T::QT, sq, n_heads, 128);
  const size_t st0 = ((size_t)b * n_heads + h) * sq;
  const RowStats st[2] = {row_stats(m, l, delta, st0 + r0, r0 < sq),
                          row_stats(m, l, delta, st0 + r0 + 8, r0 + 8 < sq)};

  // causal: the keys up to the tile's last row (none for a tile whose rows
  // all see no key: their gradient is 0)
  const int last = min(q0 + T::QT, sq) - 1;
  const int k_end = causal ? min(skv, max(0, last + off + 1)) : skv;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int c0 = 0; c0 < k_end; c0 += T::KC) {
    __syncthreads();                              // the last chunk is read
    load_rows<D>(ks, T::LD, k + ((size_t)b * skv * n_kv_heads + kh) * D, c0,
                 T::KC, skv, n_kv_heads, 128);
    load_rows<DV>(vs, T::LDV, v + ((size_t)b * skv * n_kv_heads + kh) * DV,
                  c0, T::KC, skv, n_kv_heads, 128);
    __syncthreads();
    float s[NB][4], dp[NB][4];
    mma_abt<D, NB>(s, qs + warp * 16 * T::LD, T::LD, ks, T::LD);
    mma_abt<DV, NB>(dp, dos + warp * 16 * T::LDV, T::LDV, vs, T::LDV);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + 8 * n + 2 * t4 + (e & 1);
        const int row = r0 + (e >= 2 ? 8 : 0);
        const bool masked = key >= skv || (causal && key > row + off);
        const RowStats& rs = st[e >= 2];
        const float p = weight(s[n][e], scale_log2, rs, masked);
        s[n][e] = masked ? 0.f : p * (dp[n][e] - rs.dd);
      }
    }
    mma_xy<D, T::KC / 16>(acc, s, ks, T::LD);      // dQ += dS K
  }
  store_rows<D>(dq + ((size_t)b * sq * n_heads + h) * D, (size_t)n_heads * D,
                acc, q0 + warp * 16, sq, scale);
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
int launch_mma(const bf16* q, const bf16* k, const bf16* v,
               const bf16* dout, const float* m, const float* l,
               const float* delta, bf16* dq, bf16* dk, bf16* dv, int n_b,
               int sq, int skv, int n_heads, int n_kv_heads, float scale,
               int causal, cudaStream_t st) {
  using T = BwdTile<D, DV>;
  static bool ready = false;      // shared memory past 48 KB, asked for once
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_mma<D, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_KV);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_mma<D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM_Q);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const dim3 gkv((skv + T::BK - 1) / T::BK, n_kv_heads, n_b);
  flash_bwd_dkdv_mma<D, DV><<<gkv, 256, T::SMEM_KV, st>>>(
      q, k, v, dout, m, l, delta, dk, dv, sq, skv, n_heads, n_kv_heads, scale,
      causal);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 gq((sq + T::QT - 1) / T::QT, n_heads, n_b);
  flash_bwd_dq_mma<D, DV><<<gq, 128, T::SMEM_Q, st>>>(
      q, k, v, dout, m, l, delta, dq, sq, skv, n_heads, n_kv_heads, scale,
      causal);
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
// [n_b, n_heads, sq] float32 scratch; dq, dk, dv like q, k, v.  (d, dv) one
// of PANDADB_FLASH_PAIRS; skv >= 1.  Three launches on `stream`; returns
// the first cudaError_t that is not success.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* m,
                                   const float* l, float* delta, void* dq,
                                   void* dk, void* dv, int n_b, int sq,
                                   int skv, int n_heads, int n_kv_heads,
                                   int d, int dvw, int dtype, float scale,
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
    return launch_mma<DIM, DIMV>(                                             \
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),             \
        static_cast<const bf16*>(v), db, m, l, delta,                         \
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
