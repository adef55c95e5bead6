// flash_attention: causal (or full) attention with an online softmax, for
// Hopper.
//
// Replaces the Pallas kernel flash_attention_pallas (body _flash_kernel) of
// src/repro/kernels/flash_attention/flash_attention.py, and with it the
// reference model's chunked_attention (src/repro/models/attention.py), its
// XLA form.  q [B, Sq, H, D], k [B, Skv, KVH, D] and v [B, Skv, KVH, Dv]
// with KVH dividing H: query head h reads key head h / (H / KVH) in place,
// so grouped-query attention needs no repeat_kv copy of k and v.  Query row
// i sits at position i + Skv - Sq (right-aligned, as chunked_attention
// places it); under causal a row at a negative position sees no key, and
// its -1e30 scores weigh every key alike, as the reference's do (keys past
// Skv in a ragged tile score -inf, so they weigh nothing even there).  The
// kernel is compiled for the (D, Dv) pairs of the launch switch below; the
// wrapper zero-pads any other pair.  Scores are q . k * scale in
// float32; masked scores are -1e30 (not -inf, so a fully masked tile keeps a
// finite max); m, l and the accumulator are float32; l is floored at 1e-30;
// the output is in q's type.  With bf16_probs the softmax weights are
// rounded to bfloat16 before P.V (l sums them unrounded), as
// chunked_attention does.  Any Sq and Skv run: keys past Skv and rows past
// Sq are masked, with no fallback to another path.  Key tiles past the
// causal diagonal of a
// query tile are not loaded at all (the Pallas kernel's `run` skip), and the
// heaviest query tiles start first so the short ones fill the tail.
// Given m and l pointers (float32, [B, H, Sq]), each row's softmax
// statistics are written there for the backward (flash_attention_bwd.cu):
// m its largest scaled score (-1e30 for a row that sees no key), l the sum
// of exp(score - m) over the row; with null pointers nothing is written.
//
// Bound: at the prefill's shapes (S = 4,096, D = 128) attention does
// 2 B H S^2 D causal operations on 2 B S (H + 2 KVH) D bytes, so it is bound
// by operations, at the bf16 tensor-core rate for bf16 inputs.  Two paths:
//
// * bfloat16 (the LM's type): Hopper's warpgroup MMA (wgmma, sm_90a) for
//   both products, fed by the TMA unit.  A block holds 128 query rows, 64
//   for each of two consumer warpgroups, and a producer warpgroup whose one
//   thread keeps a ring of K/V tiles (128 keys; 64 past D or Dv = 128) in
//   flight,
//   each completing on an mbarrier and refilled once both consumers release
//   it; the producer hands its registers to the consumers (setmaxnreg).  S
//   = Q K^T is one wgmma m64nWKk16 per 16 columns of D, A and B read from
//   shared memory; O += P V is one m64nDVk16 per 16 keys, P from registers
//   and V read in place as the transposed B operand.  A consumer issues
//   S_t and P_{t-1} V_{t-1} together, exponentiates S_t as soon as it
//   completes while P V runs on, then rescales O; the two consumers take
//   turns to issue (named barriers), so one's softmax runs under the
//   other's products.  The softmax is in base 2 with the scale folded into
//   the exponent's FMA; only tiles that cross the diagonal or the end of S
//   are masked, and no wgmma sits under a run-time branch (the compiler
//   would serialise them all): a tile wholly above a warpgroup's rows runs
//   fully masked, its weights exactly 0.  bf16 products of bf16 inputs are
//   exact in float32, so Q K^T is the float32 score.  P is float32, which
//   the tensor cores do not take: it goes in as two bf16 terms, hi =
//   bf16(p) and lo = bf16(p - hi), so each weight keeps 16 bits (relative
//   error <= 2^-16); with bf16_probs only hi goes in, which is exactly the
//   rounding chunked_attention applies, on each key tile's running max.
//   Key tiles past the block's last row are never loaded.
// * float32 (the parity configs): float32 FMAs on the SIMT cores, since
//   TF32 tensor cores would change the scores.  Four threads per query row,
//   each with a quarter of the row's scaled q and accumulator in registers
//   as float4 chunks; K and V tiles of 32 keys (16 at the widest pairs) in
//   shared memory; a row's score is its four threads' partial dots summed
//   by two warp shuffles.
#include <cmath>

#include "attention_dtype.cuh"
#include "hopper.cuh"
#include "tma_map.cuh"

namespace {

using pandadb::ATTN_NEG;

constexpr int BQ = 64;                // query rows per block
constexpr int LANES = 4;              // threads per query row
constexpr int THREADS = BQ * LANES;   // 256
constexpr int MAX_GRID = 65535;

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

using bf16 = __nv_bfloat16;
using pandadb::wgmma_desc;

constexpr int WQ = 128;               // query rows per block, 64 a warpgroup
constexpr int CONSUMERS = 256;        // two warpgroups
constexpr int WTHREADS = CONSUMERS + 128;  // and a producer warpgroup
constexpr int SMEM_MAX = 232448;      // shared memory a block may use

using pandadb::chunk_of;
using pandadb::make_map;

// The tiles of head widths D (q, k) and DV (v, o).  Each is read in column
// chunks (hopper.cuh): W of D, WV of DV; Q, K and V tiles are stored chunk
// after chunk, each chunk row-major and swizzled.  Key tiles hold WK keys
// (128; 64 past a width of 128, whose O or scores would not fit the
// registers beside it), in a ring of as many stages as fit, up to 4.
template <int D, int DV>
struct Tile {
  static constexpr int W = chunk_of(D);
  static constexpr int WV = chunk_of(DV);
  static constexpr int WK = D > 128 || DV > 128 ? 64 : 128;
  static constexpr uint32_t MODE = pandadb::wgmma_swizzle(2 * W);
  static constexpr uint32_t SBO = 8 * 2 * W;   // bytes between 8-row groups
  static constexpr uint32_t MODE_V = pandadb::wgmma_swizzle(2 * WV);
  static constexpr uint32_t SBO_V = 8 * 2 * WV;
  static constexpr int Q_BYTES = WQ * D * 2;
  static constexpr int STAGE_BYTES = WK * (D + DV) * 2;   // K and V
  static constexpr int STAGES =
      (SMEM_MAX - 1024 - Q_BYTES) / STAGE_BYTES < 4
          ? (SMEM_MAX - 1024 - Q_BYTES) / STAGE_BYTES
          : 4;
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE_BYTES;
  static_assert(STAGES >= 2, "two stages at least");
};

// two floats as one bf16x2 register, the first in the low half (the lower
// column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x, flushing results below 2^-126 to zero (weights that small vanish
// in the float32 sums anyway)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the two bf16 halves of a packed pair, back as floats
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// S[64 x WK] = Q[64 x D] K^T for one warpgroup: qw its 64 rows of chunk 0
// of the Q tile, kt chunk 0 of the K tile; 16 columns of D a step.
template <int D, int DV>
__device__ __forceinline__ void qk_mma(float* s, const bf16* qw,
                                       const bf16* kt) {
  using T = Tile<D, DV>;
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const int c = k * 16 / T::W, off = k * 16 % T::W;
    const uint64_t da = wgmma_desc(qw + c * WQ * T::W + off, 16, T::SBO,
                                   T::MODE);
    const uint64_t db = wgmma_desc(kt + c * T::WK * T::W + off, 16, T::SBO,
                                   T::MODE);
    if constexpr (T::WK == 128) pandadb::wgmma_ss_n128(s, da, db, 1);
    if constexpr (T::WK == 64) pandadb::wgmma_ss_n64(s, da, db, 1);
  }
}

// O[64 x DV] += P[64 x 16] V[16 x DV] for one warpgroup: P in registers,
// v16 the first of the 16 keys' rows in chunk 0 of the V tile (N-major B,
// so V is read as stored; LBO steps from chunk to chunk).
template <int D, int DV>
__device__ __forceinline__ void pv_mma(float* o, const uint32_t* p,
                                       const bf16* v16) {
  using T = Tile<D, DV>;
  const uint64_t desc = wgmma_desc(v16, 2 * T::WK * T::WV, T::SBO_V,
                                   T::MODE_V);
  if constexpr (DV == 16) pandadb::wgmma_rs_n16(o, p, desc, 1);
  if constexpr (DV == 32) pandadb::wgmma_rs_n32(o, p, desc, 1);
  if constexpr (DV == 64) pandadb::wgmma_rs_n64(o, p, desc, 1);
  if constexpr (DV == 128) pandadb::wgmma_rs_n128(o, p, desc, 1);
  if constexpr (DV == 160) pandadb::wgmma_rs_n160(o, p, desc, 1);
  if constexpr (DV == 192) pandadb::wgmma_rs_n192(o, p, desc, 1);
  if constexpr (DV == 256) pandadb::wgmma_rs_n256(o, p, desc, 1);
}

// q [B, Sq, H, D], k [B, Skv, KVH, D] and v [B, Skv, KVH, DV] reach the
// kernel as TMA tensor maps whose boxes land in the chunked layout: the
// map's dimensions are (W columns, position, column chunk, head, batch), so
// a box of (W, rows, D / W, 1, 1) is stored chunk after chunk, swizzled by
// the TMA unit.  Positions past Sq or Skv are filled with zeros by the TMA
// unit.
template <int D, int DV, bool HI_ONLY>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                bf16* __restrict__ o, float* __restrict__ m_out,
                float* __restrict__ l_out, int sq, int skv, int n_heads,
                int n_kv_heads, float scale_log2, int causal) {
  using T = Tile<D, DV>;
  constexpr int WK = T::WK;
  constexpr int ST = T::STAGES;
  constexpr int NO = DV / 2;          // O accumulator registers a thread
  constexpr int NS = WK / 2;          // S accumulator registers a thread
  constexpr int PK = WK / 16;         // k-steps of P V
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[ST], empty[ST], q_full;
  bf16* qs = reinterpret_cast<bf16*>(smem);   // the 128-row Q tile
  bf16* ks = qs + WQ * D;                     // ST K tiles
  bf16* vs = ks + ST * WK * D;                // ST V tiles

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (n_heads / n_kv_heads);
  const int q0 = qt * WQ;
  const int off = skv - sq;                    // query row i at i + off
  // causal: keys up to the tile's last row; a tile with a row at a negative
  // position (Sq > Skv) weighs every key, so it loads them all
  const int k_end = causal && q0 + off >= 0 ? min(skv, q0 + WQ + off) : skv;
  const int n_tiles = (k_end + WK - 1) / WK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      pandadb::mbar_init(&full[s], 1);
      pandadb::mbar_init(&empty[s], CONSUMERS);
    }
    pandadb::mbar_init(&q_full, 1);
    pandadb::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer warpgroup gives its registers to the consumers; one
    // thread keeps ST K/V tiles in flight, each refilled once both
    // consumer warpgroups have released it
    pandadb::regs_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      pandadb::mbar_expect_tx(&q_full, T::Q_BYTES);
      pandadb::tma_load_5d(qs, &q_map, &q_full, 0, q0, 0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) pandadb::mbar_wait(&empty[s], (t / ST - 1) & 1);
        pandadb::mbar_expect_tx(&full[s], T::STAGE_BYTES);
        pandadb::tma_load_5d(ks + s * WK * D, &k_map, &full[s], 0, t * WK, 0,
                             kh, b);
        pandadb::tma_load_5d(vs + s * WK * DV, &v_map, &full[s], 0, t * WK,
                             0, kh, b);
      }
    }
    return;
  }
  pandadb::regs_inc<240>();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int t4 = lane % 4;
  const int w0 = q0 + wg * 64;                 // this warpgroup's first row
  const int r0 = w0 + warp * 16 + gr;          // the two rows this thread
  const int r1 = r0 + 8;                       // holds in accumulators
  const bool w_live = w0 < sq;
  const bf16* qw = qs + wg * 64 * T::W;        // its 64 rows of each chunk

  // ping-pong: the warpgroups take turns to issue their products (named
  // barrier 1 + wg is this one's turn), so one's softmax runs under the
  // other's tensor-core work
  const int my_turn = 1 + wg, other_turn = 2 - wg;

  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  float m0 = ATTN_NEG, m1 = ATTN_NEG, l0 = 0.f, l1 = 0.f;
  float sc[NS];
  uint32_t hi[PK][4], lo[PK][4];    // P of the previous tile, as A operands

  // Every tile of the block runs through both warpgroups, also one wholly
  // above a warpgroup's rows (at WK = 64) or past Skv: its scores are masked
  // to -1e30, whose weights are exactly 0 once a row has seen a real key
  // (key 0 is in tile 0 and every row at a position >= 0 sees it).  So no
  // product sits under a run-time condition, which would make the compiler
  // serialise every wgmma.

  // scores of tile t -> weights in sc, running max and sums updated;
  // (a0, a1) rescale O
  auto softmax = [&](int t, float& a0, float& a1) {
    const int k0 = t * WK;
    // a tile that crosses the diagonal or the end of Skv is scaled and
    // masked first; any other is scaled inside the exponent's FMA, its max
    // taken unscaled (scaling by a positive factor keeps the order)
    float mul = scale_log2;
    if ((causal && k0 + WK - 1 > w0 + off) || k0 + WK > skv ||
        !(mul > 0.f)) {
#pragma unroll
      for (int j = 0; j < WK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + t4 * 2 + (e & 1);
          const int row = e < 2 ? r0 : r1;
          sc[4 * j + e] = key >= skv ? -INFINITY
                          : causal && key > row + off
                              ? ATTN_NEG
                              : sc[4 * j + e] * scale_log2;
        }
      }
      mul = 1.f;
    }
    float mx0 = ATTN_NEG, mx1 = ATTN_NEG;
#pragma unroll
    for (int j = 0; j < WK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w *= 2) {           // the row's four threads
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0 * mul), mn1 = fmaxf(m1, mx1 * mul);
    a0 = exp2_ftz(m0 - mn0);
    a1 = exp2_ftz(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < WK / 8; ++j) {
      sc[4 * j] = exp2_ftz(fmaf(sc[4 * j], mul, -mn0));
      sc[4 * j + 1] = exp2_ftz(fmaf(sc[4 * j + 1], mul, -mn0));
      sc[4 * j + 2] = exp2_ftz(fmaf(sc[4 * j + 2], mul, -mn1));
      sc[4 * j + 3] = exp2_ftz(fmaf(sc[4 * j + 3], mul, -mn1));
      ps0 += sc[4 * j] + sc[4 * j + 1];
      ps1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * a0 + ps0;                        // this thread's columns; the
    l1 = l1 * a1 + ps1;                        // quad sums them at the end
    m0 = mn0;
    m1 = mn1;
  };
  // the weights in sc as A operands (keys 16j .. 16j + 15 are the score
  // columns 8(2j) .. 8(2j + 1) + 7): hi = bf16(p), lo = bf16(p - hi)
  auto pack = [&]() {
#pragma unroll
    for (int j = 0; j < PK; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* x = sc + 8 * j + 2 * r;
        hi[j][r] = pack_bf16(x[0], x[1]);
        if constexpr (!HI_ONLY)
          lo[j][r] = pack_bf16(x[0] - bf16_lo(hi[j][r]),
                               x[1] - bf16_hi(hi[j][r]));
      }
    }
  };
  auto pv = [&](const bf16* vt) {
#pragma unroll
    for (int j = 0; j < PK; ++j) {             // 16 keys (2 row groups) a step
      pv_mma<D, DV>(oacc, hi[j], vt + j * 16 * T::WV);
      if constexpr (!HI_ONLY)
        pv_mma<D, DV>(oacc, lo[j], vt + j * 16 * T::WV);
    }
  };
  auto take_turn = [&]() { pandadb::named_bar_sync(my_turn, CONSUMERS); };
  auto pass_turn = [&](int t) {
    if (wg == 0 || t + 1 < n_tiles)
      pandadb::named_bar_arrive(other_turn, CONSUMERS);
  };

  pandadb::mbar_wait(&q_full, 0);
  if (wg == 1) pandadb::named_bar_arrive(1, CONSUMERS);   // wg 0 goes first

  // tile 0: S only
  pandadb::mbar_wait(&full[0], 0);
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.f;
  take_turn();
  pandadb::wgmma_fence();
  qk_mma<D, DV>(sc, qw, ks);
  pandadb::wgmma_commit();
  pass_turn(0);
  pandadb::wgmma_wait<0>();
  pandadb::fence_regs<NS>(sc);
  {
    float a0, a1;
    softmax(0, a0, a1);
  }
  pack();

  // tile t: S = Q K_t^T and O += P_{t-1} V_{t-1} as two groups; S is
  // exponentiated once its group completes, P V still running
  for (int t = 1; t < n_tiles; ++t) {
    const int s = t % ST;
    const int sp = (t - 1) % ST;
    pandadb::mbar_wait(&full[s], (t / ST) & 1);
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    take_turn();
    pandadb::fence_regs<NO>(oacc);
    pandadb::wgmma_fence();
    qk_mma<D, DV>(sc, qw, ks + s * WK * D);
    pandadb::wgmma_commit();
    pv(vs + sp * WK * DV);
    pandadb::wgmma_commit();
    pass_turn(t);
    pandadb::wgmma_wait<1>();                  // S is done, P V may run on
    pandadb::fence_regs<NS>(sc);
    float a0, a1;
    softmax(t, a0, a1);
    pandadb::wgmma_wait<0>();                  // P_{t-1} V_{t-1} is in O
    pandadb::fence_regs<NO>(oacc);
    pandadb::mbar_arrive(&empty[sp]);          // tile t - 1 is done
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      oacc[4 * n] *= a0;
      oacc[4 * n + 1] *= a0;
      oacc[4 * n + 2] *= a1;
      oacc[4 * n + 3] *= a1;
    }
    pack();
  }
  // the last tile's P V
  pandadb::fence_regs<NO>(oacc);
  pandadb::wgmma_fence();
  pv(vs + ((n_tiles - 1) % ST) * WK * DV);
  pandadb::wgmma_commit();
  pandadb::wgmma_wait<0>();
  pandadb::fence_regs<NO>(oacc);

  if (!w_live) return;
#pragma unroll
  for (int w = 1; w < 4; w *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  if (m_out != nullptr && t4 == 0) {
    // m runs in base 2 on scaled scores; a row that saw no key keeps the
    // unscaled -1e30
    const size_t st = ((size_t)b * n_heads + h) * sq;
    if (r0 < sq) {
      m_out[st + r0] = m0 == ATTN_NEG ? ATTN_NEG : m0 * 0.6931471805599453f;
      l_out[st + r0] = l0;
    }
    if (r1 < sq) {
      m_out[st + r1] = m1 == ATTN_NEG ? ATTN_NEG : m1 * 0.6931471805599453f;
      l_out[st + r1] = l1;
    }
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const size_t o_stride = (size_t)n_heads * DV;
  bf16* ob = o + ((size_t)b * sq * n_heads + h) * DV;
#pragma unroll
  for (int n = 0; n < NO / 4; ++n) {
    const int c = n * 8 + t4 * 2;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * o_stride + c) =
          pack_bf16(oacc[4 * n] * inv0, oacc[4 * n + 1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * o_stride + c) =
          pack_bf16(oacc[4 * n + 2] * inv1, oacc[4 * n + 3] * inv1);
  }
}

// keys per shared tile of the float32 path: 32, or 16 where 32 keys' K and
// V rows would pass the 40 KB the static tiles may take
template <int D, int DV>
constexpr int F32_KEYS = 32 * (D + DV) * 4 <= 40960 ? 32 : 16;

template <int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ m_out, float* __restrict__ l_out, int sq,
          int skv, int n_heads, int n_kv_heads, float scale, int causal,
          int bf16_probs) {
  constexpr int C = D / (4 * LANES);   // float4 chunks of q per thread
  constexpr int CV = DV / (4 * LANES); // and of the accumulator
  constexpr int BK = F32_KEYS<D, DV>;
  __shared__ float4 ks[BK][D / 4];
  __shared__ float4 vs[BK][DV / 4];

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (n_heads / n_kv_heads);
  const int row = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const int qp = qt * BQ + row;                // this row's query index
  const int off = skv - sq;                    // its position is qp + off
  const bool live = qp < sq;

  float4 qr[C], acc[CV];
  const size_t q_off = (((size_t)b * sq + qp) * n_heads + h) * D;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d = 4 * (lane + c * LANES);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      x.x = q[q_off + d] * scale;
      x.y = q[q_off + d + 1] * scale;
      x.z = q[q_off + d + 2] * scale;
      x.w = q[q_off + d + 3] * scale;
    }
    qr[c] = x;
  }
#pragma unroll
  for (int c = 0; c < CV; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = ATTN_NEG, l = 0.f;

  // causal: keys up to the block's last row; a block with a row at a
  // negative position (Sq > Skv) weighs every key, so it reads them all
  const int q0 = qt * BQ;
  const int k_end = causal && q0 + off >= 0 ? min(skv, q0 + BQ + off) : skv;
  const size_t kv_base = (size_t)b * skv * n_kv_heads + kh;
  float* ksf = reinterpret_cast<float*>(ks);
  float* vsf = reinterpret_cast<float*>(vs);

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                       // the last tile has been read
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int j = e / D;
      ksf[e] = k0 + j < skv
                   ? k[(kv_base + (size_t)(k0 + j) * n_kv_heads) * D + e - j * D]
                   : 0.f;
    }
    for (int e = threadIdx.x; e < BK * DV; e += THREADS) {
      const int j = e / DV;
      vsf[e] = k0 + j < skv ? v[(kv_base + (size_t)(k0 + j) * n_kv_heads) * DV +
                                e - j * DV]
                            : 0.f;
    }
    __syncthreads();

    float sc[BK];
    float m_cur = ATTN_NEG;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) part += dot4(qr[c], ks[j][lane + c * LANES]);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + j;
      // keys past Skv weigh nothing, even in a row that sees no key
      sc[j] = kp >= skv ? -INFINITY
              : causal && kp > qp + off ? ATTN_NEG
                                        : part;
      m_cur = fmaxf(m_cur, sc[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(sc[j] - m_new);
      psum += p;
      sc[j] = bf16_probs ? __bfloat162float(__float2bfloat16(p)) : p;
    }
    l = l * alpha + psum;
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = sc[j];
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        const float4 x = vs[j][lane + c * LANES];
        acc[c].x += p * x.x;
        acc[c].y += p * x.y;
        acc[c].z += p * x.z;
        acc[c].w += p * x.w;
      }
    }
    m = m_new;
  }

  if (!live) return;
  if (m_out != nullptr && lane == 0) {
    const size_t st = ((size_t)b * n_heads + h) * sq + qp;
    m_out[st] = m;
    l_out[st] = l;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  const size_t o_off = (((size_t)b * sq + qp) * n_heads + h) * DV;
#pragma unroll
  for (int c = 0; c < CV; ++c) {
    const int d = 4 * (lane + c * LANES);
    o[o_off + d] = acc[c].x * inv;
    o[o_off + d + 1] = acc[c].y * inv;
    o[o_off + d + 2] = acc[c].z * inv;
    o[o_off + d + 3] = acc[c].w * inv;
  }
}

// The compiled (D, DV) pairs: equal widths, and MLA's prefill (192, 128).
#define PANDADB_FLASH_PAIRS(X)                                                \
  X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(160, 160) X(192, 192)           \
  X(256, 256) X(192, 128)

cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* o, float* m, float* l, int n_b, int sq, int skv,
                       int n_heads, int n_kv_heads, int d, int dv, float scale,
                       int causal, int bf16_probs, cudaStream_t st) {
  const dim3 grid((sq + BQ - 1) / BQ, n_heads, n_b);
#define PANDADB_FLASH(DIM, DIMV)                                              \
  case DIM * 1000 + DIMV:                                                     \
    flash_fwd<DIM, DIMV><<<grid, THREADS, 0, st>>>(                           \
        q, k, v, o, m, l, sq, skv, n_heads, n_kv_heads, scale, causal,        \
        bf16_probs);                                                          \
    break;
  switch (d * 1000 + dv) {
    PANDADB_FLASH_PAIRS(PANDADB_FLASH)
    default:
      return cudaErrorInvalidValue;
  }
#undef PANDADB_FLASH
  return cudaGetLastError();
}

template <int D, int DV, bool HI_ONLY>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                 float* m, float* l, int n_b, int sq, int skv, int n_heads,
                 int n_kv_heads, float scale, int causal, cudaStream_t st) {
  using T = Tile<D, DV>;
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, n_b, sq, n_heads, D, T::W, WQ);
  if (err == 0) err = make_map(&km, k, n_b, skv, n_kv_heads, D, T::W, T::WK);
  if (err == 0)
    err = make_map(&vm, v, n_b, skv, n_kv_heads, DV, T::WV, T::WK);
  if (err != 0) return err;
  static bool ready = false;     // shared memory past 48 KB, asked for once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma<D, DV, HI_ONLY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const dim3 grid((sq + WQ - 1) / WQ, n_heads, n_b);
  flash_fwd_wgmma<D, DV, HI_ONLY><<<grid, WTHREADS, T::SMEM, st>>>(
      qm, km, vm, o, m, l, sq, skv, n_heads, n_kv_heads,
      scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

// A tensor map the driver refuses returns 10000 + its CUresult.
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* m,
                float* l, int n_b, int sq, int skv, int n_heads, int n_kv_heads,
                int d, int dv, float scale, int causal, int bf16_probs,
                cudaStream_t st) {
#define PANDADB_FLASH(DIM, DIMV)                                              \
  case DIM * 1000 + DIMV:                                                     \
    return bf16_probs                                                         \
               ? launch_wgmma<DIM, DIMV, true>(q, k, v, o, m, l, n_b, sq, skv,\
                                               n_heads, n_kv_heads, scale,    \
                                               causal, st)                    \
               : launch_wgmma<DIM, DIMV, false>(q, k, v, o, m, l, n_b, sq,    \
                                                skv, n_heads, n_kv_heads,     \
                                                scale, causal, st);
  switch (d * 1000 + dv) {
    PANDADB_FLASH_PAIRS(PANDADB_FLASH)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PANDADB_FLASH
}

}  // namespace

// q [n_b, sq, n_heads, d], k [n_b, skv, n_kv_heads, d], v [n_b, skv,
// n_kv_heads, dv], o [n_b, sq, n_heads, dv], all contiguous, of type dtype
// (0 float32, 1 bfloat16; bfloat16 pointers 16-byte aligned); (d, dv) one of
// PANDADB_FLASH_PAIRS; skv >= 1.  m and l, float32 [n_b, n_heads, sq] or
// both null, receive the row statistics.  Returns cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, float* m, float* l, int n_b, int sq,
                               int skv, int n_heads, int n_kv_heads, int d,
                               int dv, int dtype, float scale, int causal,
                               int bf16_probs, void* stream) {
  if (n_b <= 0 || sq <= 0) return 0;
  if (skv <= 0 || n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      n_heads > MAX_GRID || n_b > MAX_GRID)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == pandadb::DTYPE_F32)
    return (int)launch_f32(static_cast<const float*>(q),
                           static_cast<const float*>(k),
                           static_cast<const float*>(v),
                           static_cast<float*>(o), m, l, n_b, sq, skv, n_heads,
                           n_kv_heads, d, dv, scale, causal, bf16_probs, st);
  if (dtype == pandadb::DTYPE_BF16)
    return launch_bf16(static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<bf16*>(o), m, l,
                       n_b, sq, skv, n_heads, n_kv_heads, d, dv, scale, causal,
                       bf16_probs, st);
  return (int)cudaErrorInvalidValue;
}

// Keys per tile of the kernel for dtype at head widths (d, dv) (0 for a pair
// it does not take): with bf16_probs each tile's weights are rounded on its
// own running max.
extern "C" int flash_attention_key_tile(int d, int dv, int dtype) {
#define PANDADB_FLASH(DIM, DIMV)                                              \
  case DIM * 1000 + DIMV:                                                     \
    return dtype == pandadb::DTYPE_F32 ? F32_KEYS<DIM, DIMV>                  \
                                       : Tile<DIM, DIMV>::WK;
  switch (d * 1000 + dv) {
    PANDADB_FLASH_PAIRS(PANDADB_FLASH)
    default:
      return 0;
  }
#undef PANDADB_FLASH
}
