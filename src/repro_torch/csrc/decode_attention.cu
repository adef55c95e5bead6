// decode_attention: one new token's grouped-query attention over a KV cache,
// split into fixed chunks of keys, for Hopper.
//
// Replaces the Pallas kernel decode_attention_pallas (body _decode_kernel) of
// src/repro/kernels/decode_attention/decode_attention.py, with its jnp
// epilogue that combines the splits (decode_attention.py:110-116), and with
// them the reference model's grouped decode_attention
// (src/repro/models/attention.py), its XLA form.  q [B, 1, H, D]; the caches
// k [B, S, KVH, D] and v [B, S, KVH, Dv] are read in place (no transpose
// copy, no repeat_kv, no padded copy); pos [B] int32 is the new token's
// position, read on the card, and keys past it score -1e30.  m, l and the
// accumulators are float32; the output is in q's type.  Any D and Dv up to
// 256 and any G = H / KVH run.
//
// Bound: decoding does 4 G D operations per cache row of D + Dv elements,
// far below the card's operations-per-byte line, so it is bound by the bytes
// of the cache rows at positions <= pos.  The design is about reading those
// bytes at the card's rate whatever the positions are:
//
// 1. The chunk pass, grid (B * chunks * KVH, row groups).  A block owns C
//    keys (the wrapper's CHUNK_KEYS) of one batch row and key head, and the
//    G query rows that share that key head (16 a row group; more G run as
//    more row groups), so each cache row is read from device memory once
//    for all of them.  A block whose chunk starts past its row's visible
//    keys [0, min(pos[b] + 1, S)) returns at once, so the work spreads over
//    the card by chunks, not by rows: a long row is many blocks, a short one
//    few.  Blocks run key head fastest, so neighbouring blocks read the
//    neighbouring heads of the same cache rows.  Within a block the chunk
//    streams through a ring of 2-3 shared-memory stages of K and V rows
//    (each row padded by 16 bytes, so that eight rows read down a column hit
//    eight bank groups), filled by 16-byte cp.async copies while the block
//    works on an earlier stage; widths whose rows are not 16-byte multiples
//    are copied element by element instead.  bfloat16 (decode_chunk_mma)
//    runs both products on the tensor cores, each warp on its own quarter of
//    every stage with its own online softmax; float32 (decode_chunk) runs
//    them as float32 FMAs.  The block writes its chunk's (m, l, acc).
// 2. decode_combine, grid (B * KVH, columns / 128): for each output element,
//    the max of the row's ceil(n_vis / C) chunk maxima, weights 2^(m_c -
//    max), and sum_c acc_c w_c / max(sum_c l_c w_c, 1e-30), in q's type.
//
// Scores are in base 2: the scale and log2 e fold into one factor.
#include <cmath>

#include "attention_dtype.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using pandadb::ATTN_NEG;
using pandadb::from_float;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 16;              // query rows a block holds
constexpr int MAX_DIM = 256;          // widest D and Dv
constexpr int MAX_STAGES = 3;
// float32 blocks: 16 query rows (a block's rows past g do no work) and 32
// keys a stage, so that two or three stages fit at every width up to 256
constexpr int F32_ROWS = GMAX;
constexpr int F32_KEYS = 32;
// blocks of the chunk pass an SM holds where their stages fit: two were
// faster than three at the LM's decode shapes on an H100 (at 1,024 keys a
// chunk), three stages of 64 keys each at D = Dv = 128
constexpr int BLOCKS_PER_SM = 2;
constexpr int SMEM_MAX = 232448;      // shared memory a block may use
constexpr int MAX_GRID_YZ = 65535;

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 8 elements at p (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// 4 elements at p (4-element aligned) as floats
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

// The widths a float32 block works at: d and dv rounded up to 8 (the
// columns past them hold zeros), and the shared row strides, 16 bytes
// longer.
struct Widths {
  int dp, dvp, kst, vst;
  __host__ __device__ Widths(int d, int dv)
      : dp((d + 7) & ~7), dvp((dv + 7) & ~7), kst(dp + 4), vst(dvp + 4) {}
};

// Shared memory of a block: q rows (float32, scaled), the stage's scores
// then weights, the rows' running max, sum and rescale, then the K and V
// stages.
__host__ __device__ inline int fixed_bytes(int dp) {
  return (F32_ROWS * dp + F32_ROWS * F32_KEYS + 3 * GMAX) * 4;
}

// float32: F32_ROWS query rows a block and F32_KEYS keys a stage; VEC: rows of
// 16-byte multiples, copied with cp.async.  A stage is scored from shared
// memory (one thread a key, q broadcast from shared memory), one warp takes
// each row's online-softmax step for the whole stage, and P V runs with each
// thread holding four accumulator columns of one row.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
decode_chunk(const float* __restrict__ q, const float* __restrict__ kc,
             const float* __restrict__ vc, const int* __restrict__ pos,
             float* __restrict__ m_out, float* __restrict__ l_out,
             float* __restrict__ acc_out, int seq, int n_kv_heads, int g,
             int d, int dv, int chunk, int n_chunks, int stages,
             float scale_log2) {
  constexpr int GB = F32_ROWS;
  constexpr int TK = F32_KEYS;
  constexpr int SLOTS = THREADS / TK;             // threads on one key
  constexpr int RPT = (GB + SLOTS - 1) / SLOTS;   // rows a thread scores
  // (row, 4 columns) pairs of the accumulator a thread holds
  constexpr int PPT = (GB * (MAX_DIM / 4) + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];

  // blocks run key head fastest, then chunk, then batch row: neighbouring
  // blocks read the neighbouring heads of the same cache rows
  const int kh = blockIdx.x % n_kv_heads;
  const int ci = blockIdx.x / n_kv_heads % n_chunks;
  const int b = blockIdx.x / n_kv_heads / n_chunks;
  const int bk = b * n_kv_heads + kh;
  const int r_first = blockIdx.y * GB;
  const int rows = min(GB, g - r_first);          // rows past g do no work
  const int n_vis = min(seq, pos[b] + 1);
  const int s0 = ci * chunk;
  if (s0 >= n_vis) return;                        // past the visible keys
  const int s1 = min(s0 + chunk, n_vis);
  const int n_tiles = (s1 - s0 + TK - 1) / TK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const Widths w(d, dv);
  float* qs = reinterpret_cast<float*>(smem);     // GB x dp
  float* ps = qs + GB * w.dp;                     // GB x TK
  float* row_m = ps + GB * TK;                    // log2 units
  float* row_l = row_m + GMAX;
  float* row_a = row_l + GMAX;
  float* ks = row_a + GMAX;                       // stages x TK x kst
  float* vs = ks + (size_t)stages * TK * w.kst;   // stages x TK x vst

  const int n_heads = n_kv_heads * g;
  for (int e = tid; e < GB * w.dp; e += THREADS) {
    const int r = e / w.dp;
    const int c = e - r * w.dp;
    const int row = r_first + r;
    qs[e] = row < g && c < d
                ? q[((size_t)b * n_heads + kh * g + row) * d + c] * scale_log2
                : 0.f;
  }
  if (tid < GB) {
    row_m[tid] = ATTN_NEG;
    row_l[tid] = 0.f;
  }
  if (VEC) {
    // the columns past d (dv) up to 8, which no copy writes (float32 rows
    // of 4 mod 8 elements)
    for (int e = tid; e < stages * TK; e += THREADS) {
      for (int c = d; c < w.dp; ++c) ks[(size_t)e * w.kst + c] = 0.f;
      for (int c = dv; c < w.dvp; ++c) vs[(size_t)e * w.vst + c] = 0.f;
    }
  }

  const size_t k_row = (size_t)n_kv_heads * d;
  const size_t v_row = (size_t)n_kv_heads * dv;
  const float* kb = kc + ((size_t)b * seq * n_kv_heads + kh) * d;
  const float* vb = vc + ((size_t)b * seq * n_kv_heads + kh) * dv;

  // stage t % stages <- keys [s0 + t TK, + TK), zeros past s1
  auto load_tile = [&](int t) {
    const int key0 = s0 + t * TK;
    float* kd = ks + (size_t)(t % stages) * TK * w.kst;
    float* vd = vs + (size_t)(t % stages) * TK * w.vst;
    if constexpr (VEC) {
      constexpr int E = 4;                        // floats in 16 bytes
      const int ku = d / E, vu = dv / E;
      for (int e = tid; e < TK * ku; e += THREADS) {
        const int j = e / ku;
        const int u = e - j * ku;
        const bool ok = key0 + j < s1;
        pandadb::cp_async16(kd + j * w.kst + u * E,
                            kb + (size_t)(ok ? key0 + j : s0) * k_row + u * E,
                            ok ? 16 : 0);
      }
      for (int e = tid; e < TK * vu; e += THREADS) {
        const int j = e / vu;
        const int u = e - j * vu;
        const bool ok = key0 + j < s1;
        pandadb::cp_async16(vd + j * w.vst + u * E,
                            vb + (size_t)(ok ? key0 + j : s0) * v_row + u * E,
                            ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < TK * w.dp; e += THREADS) {
        const int j = e / w.dp;
        const int c = e - j * w.dp;
        kd[j * w.kst + c] = key0 + j < s1 && c < d
                                ? kb[(size_t)(key0 + j) * k_row + c]
                                : 0.f;
      }
      for (int e = tid; e < TK * w.dvp; e += THREADS) {
        const int j = e / w.dvp;
        const int c = e - j * w.dvp;
        vd[j * w.vst + c] = key0 + j < s1 && c < dv
                                ? vb[(size_t)(key0 + j) * v_row + c]
                                : 0.f;
      }
    }
  };
  // until at most stages - 1 copy groups are in flight: stage t has landed
  auto wait_tile = [&]() {
    if (stages == 2) pandadb::cp_async_wait<1>();
    else pandadb::cp_async_wait<2>();
  };

  for (int t = 0; t < stages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    pandadb::cp_async_commit();
  }

  const int ncd = w.dvp / 4;                      // 4-column groups of a row
  float acc[PPT][4];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + stages - 1 < n_tiles) load_tile(t + stages - 1);
    pandadb::cp_async_commit();
    wait_tile();
    __syncthreads();
    const float* kt = ks + (size_t)(t % stages) * TK * w.kst;
    const float* vt = vs + (size_t)(t % stages) * TK * w.vst;

    {  // scores: thread (key j, slot) takes rows slot, slot + SLOTS, ...
      const int j = tid % TK;
      const int slot = tid / TK;
      float s[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) s[i] = 0.f;
      const float* krow = kt + j * w.kst;
#pragma unroll 2
      for (int c = 0; c < w.dp; c += 8) {
        float kx[8];
        load8(krow + c, kx);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = slot + i * SLOTS;
          if (r < rows) {
            const float4* qq = reinterpret_cast<const float4*>(qs + r * w.dp + c);
            const float4 a = qq[0], e = qq[1];
            s[i] += a.x * kx[0] + a.y * kx[1] + a.z * kx[2] + a.w * kx[3] +
                    e.x * kx[4] + e.y * kx[5] + e.z * kx[6] + e.w * kx[7];
          }
        }
      }
      const bool ok = s0 + t * TK + j < s1;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = slot + i * SLOTS;
        if (r < rows) ps[r * TK + j] = ok ? s[i] : ATTN_NEG;
      }
    }
    __syncthreads();

    // one online-softmax step a row for the whole stage, a warp a row
    for (int r = warp; r < rows; r += WARPS) {
      float mx = ATTN_NEG;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, ps[r * TK + j]);
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float p = exp2_ftz(ps[r * TK + j] - m_new);
        ps[r * TK + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = exp2_ftz(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // P V: pair i of this thread is (row r, columns c .. c + 3)
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int pr = tid + i * THREADS;
      if (pr < rows * ncd) {
        const int r = pr / ncd;
        const int c = (pr - r * ncd) * 4;
        const float alpha = row_a[r];
        float x0 = acc[i][0] * alpha, x1 = acc[i][1] * alpha;
        float x2 = acc[i][2] * alpha, x3 = acc[i][3] * alpha;
        const float* pw = ps + r * TK;
        const float* vcol = vt + c;
#pragma unroll 8
        for (int j = 0; j < TK; ++j) {
          const float p = pw[j];
          float vx[4];
          load4(vcol + j * w.vst, vx);
          x0 += p * vx[0];
          x1 += p * vx[1];
          x2 += p * vx[2];
          x3 += p * vx[3];
        }
        acc[i][0] = x0;
        acc[i][1] = x1;
        acc[i][2] = x2;
        acc[i][3] = x3;
      }
    }
    __syncthreads();          // the stage and the weights are free again
  }

  // the chunk's partial: [B * KVH, chunks, G] (m, l), [.., G, Dv] (acc)
  const size_t part = (size_t)bk * n_chunks + ci;
  if (tid < rows) {
    m_out[part * g + r_first + tid] = row_m[tid];
    l_out[part * g + r_first + tid] = row_l[tid];
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int pr = tid + i * THREADS;
    if (pr < rows * ncd) {
      const int r = pr / ncd;
      const int c = (pr - r * ncd) * 4;
      float* dst = acc_out + (part * g + r_first + r) * dv;
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (c + x < dv) dst[c + x] = acc[i][x];
    }
  }
}

// bfloat16: the same chunk on the tensor cores (mma.sync m16n8k16).  The 16
// query rows of a row group are A; each warp takes 16 of a stage's 64 keys
// and keeps its own online softmax (m, l a row) and O [16 x Dv] over them,
// so no barrier separates its scores from its P V: S = Q K^T for its keys
// (K rows through ldmatrix as B), the step's weights in registers, O += P V
// with P as A (hi = bf16(p) and lo = bf16(p - hi), so each weight keeps 16
// bits) and V through ldmatrix.trans.  The four warps' (m, l, O) merge in
// shared memory at the end of the chunk.  NKS and NNB bound the 16-column
// steps of D and the 8-column blocks of Dv (held in registers).
template <bool VEC, int NKS, int NNB>
__global__ void __launch_bounds__(THREADS)
decode_chunk_mma(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                 const bf16* __restrict__ vc, const int* __restrict__ pos,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 float* __restrict__ acc_out, int seq, int n_kv_heads, int g,
                 int d, int dv, int chunk, int n_chunks, int stages,
                 float scale_log2) {
  constexpr int TK = 64;                          // keys a stage, 16 a warp
  extern __shared__ __align__(16) unsigned char smem[];

  const int kh = blockIdx.x % n_kv_heads;       // as in decode_chunk
  const int ci = blockIdx.x / n_kv_heads % n_chunks;
  const int b = blockIdx.x / n_kv_heads / n_chunks;
  const int bk = b * n_kv_heads + kh;
  const int r_first = blockIdx.y * GMAX;
  const int n_vis = min(seq, pos[b] + 1);
  const int s0 = ci * chunk;
  if (s0 >= n_vis) return;                        // past the visible keys
  const int s1 = min(s0 + chunk, n_vis);
  const int n_tiles = (s1 - s0 + TK - 1) / TK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;
  const int t4 = lane % 4;

  // widths rounded up to 16 (zero columns past d and dv), rows 16 bytes
  // longer so ldmatrix's eight rows hit eight bank groups
  const int dp = (d + 15) & ~15, dvp = (dv + 15) & ~15;
  const int kst = dp + 8, vst = dvp + 8;
  bf16* ks = reinterpret_cast<bf16*>(smem);       // stages x TK x kst
  bf16* vs = ks + (size_t)stages * TK * kst;      // stages x TK x vst
  const bf16 zero = __float2bfloat16(0.f);
  if (VEC) {
    for (int e = tid; e < stages * TK; e += THREADS) {
      for (int c = d; c < dp; ++c) ks[(size_t)e * kst + c] = zero;
      for (int c = dv; c < dvp; ++c) vs[(size_t)e * vst + c] = zero;
    }
  }

  const size_t k_row = (size_t)n_kv_heads * d;
  const size_t v_row = (size_t)n_kv_heads * dv;
  const bf16* kb = kc + ((size_t)b * seq * n_kv_heads + kh) * d;
  const bf16* vb = vc + ((size_t)b * seq * n_kv_heads + kh) * dv;
  auto load_tile = [&](int t) {
    const int key0 = s0 + t * TK;
    bf16* kd = ks + (size_t)(t % stages) * TK * kst;
    bf16* vd = vs + (size_t)(t % stages) * TK * vst;
    if constexpr (VEC) {
      const int ku = d / 8, vu = dv / 8;
      for (int e = tid; e < TK * ku; e += THREADS) {
        const int j = e / ku;
        const int u = e - j * ku;
        const bool ok = key0 + j < s1;
        pandadb::cp_async16(kd + j * kst + u * 8,
                            kb + (size_t)(ok ? key0 + j : s0) * k_row + u * 8,
                            ok ? 16 : 0);
      }
      for (int e = tid; e < TK * vu; e += THREADS) {
        const int j = e / vu;
        const int u = e - j * vu;
        const bool ok = key0 + j < s1;
        pandadb::cp_async16(vd + j * vst + u * 8,
                            vb + (size_t)(ok ? key0 + j : s0) * v_row + u * 8,
                            ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < TK * dp; e += THREADS) {
        const int j = e / dp;
        const int c = e - j * dp;
        kd[j * kst + c] = key0 + j < s1 && c < d
                              ? kb[(size_t)(key0 + j) * k_row + c] : zero;
      }
      for (int e = tid; e < TK * dvp; e += THREADS) {
        const int j = e / dvp;
        const int c = e - j * dvp;
        vd[j * vst + c] = key0 + j < s1 && c < dv
                              ? vb[(size_t)(key0 + j) * v_row + c] : zero;
      }
    }
  };
  for (int t = 0; t < stages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    pandadb::cp_async_commit();
  }

  // Q's A fragments: rows gr and gr + 8 of the row group (zeros past g)
  const int n_heads = n_kv_heads * g;
  const bf16* q0 = q + ((size_t)b * n_heads + kh * g + r_first + gr) * d;
  const bf16* q1 = q0 + (size_t)8 * d;
  const bool live0 = r_first + gr < g, live1 = r_first + gr + 8 < g;
  // columns c, c + 1 (c even) as one register: one 4-byte load where d is
  // even, zeros past d
  auto q_pair = [&](const bf16* row, bool live, int c) -> uint32_t {
    if (!live || c >= d) return 0u;
    if ((d & 1) == 0) return *reinterpret_cast<const uint32_t*>(row + c);
    return (uint32_t)__bfloat16_as_ushort(row[c]) |
           (c + 1 < d ? (uint32_t)__bfloat16_as_ushort(row[c + 1]) << 16 : 0u);
  };
  uint32_t qa[NKS][4];
#pragma unroll
  for (int kk = 0; kk < NKS; ++kk) {
    const int c = kk * 16 + 2 * t4;
    qa[kk][0] = q_pair(q0, live0, c);
    qa[kk][1] = q_pair(q1, live1, c);
    qa[kk][2] = q_pair(q0, live0, c + 8);
    qa[kk][3] = q_pair(q1, live1, c + 8);
  }

  float o[NNB][4];
#pragma unroll
  for (int n = 0; n < NNB; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = ATTN_NEG, m1 = ATTN_NEG, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + stages - 1 < n_tiles) load_tile(t + stages - 1);
    pandadb::cp_async_commit();
    if (stages == 2) pandadb::cp_async_wait<1>();
    else pandadb::cp_async_wait<2>();
    __syncthreads();
    const bf16* kt = ks + ((size_t)(t % stages) * TK + warp * 16) * kst;
    const bf16* vt = vs + ((size_t)(t % stages) * TK + warp * 16) * vst;

    // S [16 rows x 16 keys]: keys 0-7 in sc[0], 8-15 in sc[1]
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const bf16* krow = kt + ((lane / 16) * 8 + lane % 8) * kst +
                       ((lane / 8) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      if (kk * 16 < dp) {
        uint32_t kf[4];
        pandadb::ldmatrix_x4(kf, krow + kk * 16);
        pandadb::mma_16816(sc[0], qa[kk], kf);
        pandadb::mma_16816(sc[1], qa[kk], kf + 2);
      }
    }
    // keys past the chunk's visible ones weigh nothing (-inf, so even a
    // warp that has seen no key yet keeps l = 0)
    const int key0 = s0 + t * TK + warp * 16 + 2 * t4;
    float mx0 = ATTN_NEG, mx1 = ATTN_NEG;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key0 + n * 8 + (e & 1) < s1;
        sc[n][e] = ok ? sc[n][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x *= 2) {             // the row's four lanes
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2_ftz(m0 - mn0), a1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      sc[n][0] = exp2_ftz(sc[n][0] - mn0);
      sc[n][1] = exp2_ftz(sc[n][1] - mn0);
      sc[n][2] = exp2_ftz(sc[n][2] - mn1);
      sc[n][3] = exp2_ftz(sc[n][3] - mn1);
      ps0 += sc[n][0] + sc[n][1];
      ps1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * a0 + ps0;            // this lane's columns; the quad sums them
    l1 = l1 * a1 + ps1;            // at the end
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = sc[n][2 * h], y = sc[n][2 * h + 1];
        const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
        hi[2 * n + h] = *reinterpret_cast<const uint32_t*>(&p);
        const __nv_bfloat162 r = __floats2bfloat162_rn(
            x - __low2float(p), y - __high2float(p));
        lo[2 * n + h] = *reinterpret_cast<const uint32_t*>(&r);
      }
    }
    // O [16 x Dv] = O * alpha + P V, 16 columns (two n-blocks) a step
    const bf16* vrow = vt + (((lane / 8) & 1) * 8 + lane % 8) * vst +
                       (lane / 16) * 8;
#pragma unroll
    for (int n = 0; n < NNB; n += 2) {
      if (n * 8 < dvp) {
        o[n][0] *= a0; o[n][1] *= a0; o[n][2] *= a1; o[n][3] *= a1;
        o[n + 1][0] *= a0; o[n + 1][1] *= a0;
        o[n + 1][2] *= a1; o[n + 1][3] *= a1;
        uint32_t vf[4];
        pandadb::ldmatrix_x4_trans(vf, vrow + n * 8);
        pandadb::mma_16816(o[n], hi, vf);
        pandadb::mma_16816(o[n], lo, vf);
        pandadb::mma_16816(o[n + 1], hi, vf + 2);
        pandadb::mma_16816(o[n + 1], lo, vf + 2);
      }
    }
    __syncthreads();          // the stage is free again
  }

  // merge the four warps' (m, l, O) in shared memory (the stages are free)
#pragma unroll
  for (int x = 1; x < 4; x *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  float* wm = reinterpret_cast<float*>(smem);     // [4][16]
  float* wl = wm + WARPS * GMAX;                  // [4][16]
  float* wo = wl + WARPS * GMAX;                  // [4][16][dvp]
  if (t4 == 0) {
    wm[warp * GMAX + gr] = m0;
    wm[warp * GMAX + gr + 8] = m1;
    wl[warp * GMAX + gr] = l0;
    wl[warp * GMAX + gr + 8] = l1;
  }
  float* wo0 = wo + ((size_t)warp * GMAX + gr) * dvp + 2 * t4;
  float* wo1 = wo0 + (size_t)8 * dvp;
#pragma unroll
  for (int n = 0; n < NNB; ++n) {
    if (n * 8 < dvp) {
      wo0[n * 8] = o[n][0];
      wo0[n * 8 + 1] = o[n][1];
      wo1[n * 8] = o[n][2];
      wo1[n * 8 + 1] = o[n][3];
    }
  }
  __syncthreads();
  const size_t part = (size_t)bk * n_chunks + ci;
  for (int e = tid; e < GMAX * dv; e += THREADS) {
    const int r = e / dv;
    const int c = e - r * dv;
    if (r_first + r >= g) break;     // e grows with r: the rest are past g
    float mt = ATTN_NEG;
#pragma unroll
    for (int x = 0; x < WARPS; ++x) mt = fmaxf(mt, wm[x * GMAX + r]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int x = 0; x < WARPS; ++x) {
      // a warp without keys has m = -1e30, l = 0, O = 0: weight 0
      const float wt = exp2_ftz(wm[x * GMAX + r] - mt);
      lt += wl[x * GMAX + r] * wt;
      at += wo[((size_t)x * GMAX + r) * dvp + c] * wt;
    }
    acc_out[(part * g + r_first + r) * dv + c] = at;
    if (c == 0) {
      m_out[part * g + r_first + r] = mt;
      l_out[part * g + r_first + r] = lt;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine(const float* __restrict__ m_in, const float* __restrict__ l_in,
               const float* __restrict__ acc_in, const int* __restrict__ pos,
               T* __restrict__ o, int seq, int n_kv_heads, int g, int dv,
               int chunk, int n_chunks) {
  const int bk = blockIdx.x;
  const int e = blockIdx.y * THREADS + threadIdx.x;
  if (e >= g * dv) return;
  const int b = bk / n_kv_heads;
  const int nc = (min(seq, pos[b] + 1) + chunk - 1) / chunk;
  const int r = e / dv;
  const size_t base = (size_t)bk * n_chunks;
  float mx = ATTN_NEG;
  for (int c = 0; c < nc; ++c) mx = fmaxf(mx, m_in[(base + c) * g + r]);
  float lsum = 0.f, num = 0.f;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const float wt = exp2_ftz(m_in[(base + c) * g + r] - mx);
    lsum += l_in[(base + c) * g + r] * wt;
    num += acc_in[(base + c) * g * dv + e] * wt;
  }
  // o [B, 1, H, Dv] with h = kh * g + r: row bk's g heads are contiguous
  o[(size_t)bk * g * dv + e] = from_float<T>(num / fmaxf(lsum, 1e-30f));
}

struct Args {
  const void *q, *kc, *vc;
  const int* pos;
  float *m, *l, *acc;
  int seq, n_kv_heads, g, d, dv, chunk, n_chunks;
  float scale_log2;
};

// Stages (at most MAX_STAGES, at least two) that fit beside `fixed` bytes
// in a block's share of an SM at BLOCKS_PER_SM blocks (or in a block's
// whole share if two stages do not fit there); 0 if none fit.
int pick_stages(int stage_bytes, int fixed, int* smem) {
  const int budgets[2] = {233472 / BLOCKS_PER_SM - 1024, SMEM_MAX};
  for (const int budget : budgets) {
    const int n = min(MAX_STAGES, (budget - fixed) / stage_bytes);
    if (n >= 2) {
      *smem = fixed + n * stage_bytes;
      return n;
    }
  }
  return 0;
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_MAX);
}

template <bool VEC, int NKS, int NNB>
cudaError_t run_mma(const Args& a, dim3 grid, int stages, int smem,
                    cudaStream_t st) {
  static bool ready = false;     // shared memory past 48 KB, asked for once
  if (!ready) {
    const cudaError_t e = allow_smem(decode_chunk_mma<VEC, NKS, NNB>);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  decode_chunk_mma<VEC, NKS, NNB><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kc),
      static_cast<const bf16*>(a.vc), a.pos, a.m, a.l, a.acc, a.seq,
      a.n_kv_heads, a.g, a.d, a.dv, a.chunk, a.n_chunks, stages,
      a.scale_log2);
  return cudaGetLastError();
}

// bfloat16: 16 rows a block, 64 keys a stage, on the tensor cores
cudaError_t launch_bf16(const Args& a, int n_b, bool vec, int n_chunks,
                        cudaStream_t st) {
  const int dp = (a.d + 15) & ~15, dvp = (a.dv + 15) & ~15;
  int smem = 0;
  const int stages = pick_stages(64 * (dp + dvp + 16) * 2, 0, &smem);
  if (!stages) return cudaErrorInvalidValue;
  const dim3 grid(n_b * n_chunks * a.n_kv_heads, (a.g + GMAX - 1) / GMAX);
  if (dp <= 128 && dvp <= 128)
    return vec ? run_mma<true, 8, 16>(a, grid, stages, smem, st)
               : run_mma<false, 8, 16>(a, grid, stages, smem, st);
  return vec ? run_mma<true, 16, 32>(a, grid, stages, smem, st)
             : run_mma<false, 16, 32>(a, grid, stages, smem, st);
}

template <bool VEC>
cudaError_t run_f32(const Args& a, dim3 grid, int stages, int smem,
                    cudaStream_t st) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = allow_smem(decode_chunk<VEC>);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  decode_chunk<VEC><<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.kc),
      static_cast<const float*>(a.vc), a.pos, a.m, a.l, a.acc, a.seq,
      a.n_kv_heads, a.g, a.d, a.dv, a.chunk, a.n_chunks, stages,
      a.scale_log2);
  return cudaGetLastError();
}

// float32: SIMT FMAs (the tensor cores would round the inputs)
cudaError_t launch_f32(const Args& a, int n_b, bool vec, int n_chunks,
                       cudaStream_t st) {
  const Widths w(a.d, a.dv);
  int smem = 0;
  const int stages = pick_stages(F32_KEYS * (w.kst + w.vst) * 4,
                                 fixed_bytes(w.dp), &smem);
  if (!stages) return cudaErrorInvalidValue;
  const dim3 grid(n_b * n_chunks * a.n_kv_heads,
                  (a.g + F32_ROWS - 1) / F32_ROWS);
  return vec ? run_f32<true>(a, grid, stages, smem, st)
             : run_f32<false>(a, grid, stages, smem, st);
}

template <typename T>
cudaError_t launch(const Args& a, void* o, int n_b, cudaStream_t st) {
  const bool vec = (a.d * sizeof(T)) % 16 == 0 &&
                   (a.dv * sizeof(T)) % 16 == 0 &&
                   (size_t)a.kc % 16 == 0 && (size_t)a.vc % 16 == 0;
  const int n_chunks = a.n_chunks;
  const cudaError_t err = sizeof(T) == 2
                              ? launch_bf16(a, n_b, vec, n_chunks, st)
                              : launch_f32(a, n_b, vec, n_chunks, st);
  if (err != cudaSuccess) return err;
  const dim3 cgrid(n_b * a.n_kv_heads, (a.g * a.dv + THREADS - 1) / THREADS);
  decode_combine<T><<<cgrid, THREADS, 0, st>>>(
      a.m, a.l, a.acc, a.pos, static_cast<T*>(o), a.seq, a.n_kv_heads, a.g,
      a.dv, a.chunk, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// q [n_b, 1, n_kv_heads * g, d], k_cache [n_b, seq, n_kv_heads, d], v_cache
// [n_b, seq, n_kv_heads, dv], o [n_b, 1, n_kv_heads * g, dv], all
// contiguous, of type dtype (0 float32, 1 bfloat16); d, dv in 1..256; pos
// [n_b] int32 >= 0; chunk a multiple of 64.  m and l hold n_b * n_kv_heads
// * ceil(seq / chunk) * g floats, acc that times dv: the chunks' partials.
// Returns cudaError_t.
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const int* pos,
                                float* m, float* l, float* acc, void* o,
                                int n_b, int seq, int n_kv_heads, int g,
                                int d, int dv, int dtype, int chunk,
                                float scale, void* stream) {
  if (n_b <= 0) return 0;
  if (seq <= 0 || n_kv_heads <= 0 || g < 1 || d < 1 || d > MAX_DIM ||
      dv < 1 || dv > MAX_DIM || chunk < 64 || chunk % 64 != 0 ||
      g > MAX_GRID_YZ ||
      (g * dv + THREADS - 1) / THREADS > MAX_GRID_YZ)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (seq + chunk - 1) / chunk;
  if ((long long)n_b * n_chunks * n_kv_heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_cache, v_cache, pos, m, l, acc, seq, n_kv_heads, g, d,
               dv, chunk, n_chunks, scale * 1.4426950408889634f};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == pandadb::DTYPE_F32) return (int)launch<float>(a, o, n_b, st);
  if (dtype == pandadb::DTYPE_BF16) return (int)launch<bf16>(a, o, n_b, st);
  return (int)cudaErrorInvalidValue;
}
