// decode_attention: one new token's grouped-query attention over a KV cache,
// split-K, for Hopper.
//
// Replaces the Pallas kernel decode_attention_pallas (body _decode_kernel) of
// src/repro/kernels/decode_attention/decode_attention.py, with its jnp
// epilogue that combines the splits (decode_attention.py:110-116), and with
// them the reference model's grouped decode_attention
// (src/repro/models/attention.py), its XLA form.  q [B, 1, H, D]; the caches
// [B, S, KVH, D] are read in place (no transpose copy, no repeat_kv); pos [B]
// int32 is the new token's position, and keys past it score -1e30.
//
// Two kernels:
// 1. decode_split, grid (B * KVH, n_splits), four warps a block.  A block
//    holds the G = H / KVH query rows that share one key head, so each cache
//    row is read from device memory once for all G of them.  The splits cut
//    the visible keys [0, min(pos[b] + 1, S)) of their batch row, not the
//    whole cache: the Pallas kernel cut S into equal splits and masked the
//    keys past pos, so a short prompt in a long cache left most splits idle
//    and one split doing all the work; here every split of row b gets
//    ceil((pos[b] + 1) / n_splits) keys, read from pos[b] on the card, with
//    no host sync.  Within a split each warp streams every fourth group of
//    KC keys straight from device memory into registers: lane i holds
//    dimensions i, i + 32, ... of the scaled q rows, of the key and value
//    rows and of its accumulators, a score is a warp all-reduce of the
//    lanes' partial dots, and the online softmax (m, l per query row) runs
//    once per group.  The four warps' (m, l, acc) merge in shared memory
//    into the split's float32 partial.  A split left without keys (a row
//    with few visible keys) loads nothing and writes m = -1e30, l = 0,
//    acc = 0, which gives it weight 0 in the combine, as the reference's
//    fully masked split has.
// 2. decode_combine, one block per (B * KVH): the global max over the
//    splits, weights exp(m_s - max), and sum_s acc_s w_s / max(sum_s l_s w_s,
//    1e-30), written in q's type.
// Any S and any pos run: the last split is shorter where n_splits does not
// divide the visible keys.
//
// Bound: decoding does 4 G D operations per cache row of 2 D elements, far
// below the card's operations-per-byte line, so it is bound by the bytes of
// the cache rows at positions <= pos (k and v).  The design reads each such
// row once, with no staging copy, and spreads the rows over
// B * KVH * n_splits * 4 warps so enough loads are in flight.
#include "attention_dtype.cuh"

namespace {

using pandadb::ATTN_NEG;
using pandadb::from_float;
using pandadb::to_float;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 4;           // keys a warp scores before one softmax step
constexpr int MAX_G = 8;        // query rows per key head
constexpr int MAX_GRID_Y = 65535;

// GP: a power of two >= g (the rows past g are masked); D: the head width
template <typename T, int D, int GP>
__global__ void __launch_bounds__(THREADS)
decode_split(const T* __restrict__ q, const T* __restrict__ kc,
             const T* __restrict__ vc, const int* __restrict__ pos,
             float* __restrict__ m_out, float* __restrict__ l_out,
             float* __restrict__ acc_out, int seq, int n_kv_heads, int g,
             float scale) {
  constexpr int DPL = (D + 31) / 32;     // dimensions per lane
  __shared__ float wm[WARPS][GP];
  __shared__ float wl[WARPS][GP];
  __shared__ float wacc[WARPS][GP][D];

  const int bk = blockIdx.x;
  const int sp = blockIdx.y;
  const int b = bk / n_kv_heads;
  const int kh = bk - b * n_kv_heads;
  const int n_heads = n_kv_heads * g;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // this split's share [s0, s1) of the visible keys [0, n_vis)
  const int n_vis = min(seq, pos[b] + 1);
  const int split_len = (n_vis + gridDim.y - 1) / gridDim.y;
  const int s0 = min(sp * split_len, n_vis);
  const int s1 = min(s0 + split_len, n_vis);

  float qr[GP][DPL], acc[GP][DPL], m[GP], l[GP];
#pragma unroll
  for (int r = 0; r < GP; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qr[r][i] = (r < g && d < D)
          ? to_float(q[((size_t)b * n_heads + kh * g + r) * D + d]) * scale
          : 0.f;
      acc[r][i] = 0.f;
    }
    m[r] = ATTN_NEG;
    l[r] = 0.f;
  }

  const size_t pos_stride = (size_t)n_kv_heads * D;
  const T* kb = kc + ((size_t)b * seq * n_kv_heads + kh) * D;
  const T* vb = vc + ((size_t)b * seq * n_kv_heads + kh) * D;
  for (int c0 = s0 + warp * KC; c0 < s1; c0 += WARPS * KC) {
    float kx[KC][DPL], vx[KC][DPL];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const bool ok = c0 + j < s1;
      const size_t row = (size_t)(c0 + j) * pos_stride;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        kx[j][i] = (ok && d < D) ? to_float(kb[row + d]) : 0.f;
        vx[j][i] = (ok && d < D) ? to_float(vb[row + d]) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < GP; ++r) {
      float s[KC];
      float mx = ATTN_NEG;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part += qr[r][i] * kx[j][i];
#pragma unroll
        for (int w = 16; w > 0; w /= 2)
          part += __shfl_xor_sync(0xffffffffu, part, w);
        s[j] = c0 + j < s1 ? part : ATTN_NEG;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float p = expf(s[j] - m_new);
        psum += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] += p * vx[j][i];
      }
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
    }
  }

  // merge the four warps' partials into the split's
#pragma unroll
  for (int r = 0; r < GP; ++r) {
    if (lane == 0) {
      wm[warp][r] = m[r];
      wl[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) wacc[warp][r][d] = acc[r][i];
    }
  }
  __syncthreads();
  const size_t part = (size_t)bk * gridDim.y + sp;
  for (int e = threadIdx.x; e < g * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    float mt = ATTN_NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, wm[w][r]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      // a warp without keys has m = -1e30, l = 0, acc = 0: weight 0
      const float x = expf(wm[w][r] - mt);
      lt += wl[w][r] * x;
      at += wacc[w][r][d] * x;
    }
    acc_out[part * g * D + e] = at;
    if (d == 0) {
      m_out[part * g + r] = mt;
      l_out[part * g + r] = lt;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine(const float* __restrict__ m_in, const float* __restrict__ l_in,
               const float* __restrict__ acc_in, T* __restrict__ o, int g,
               int d, int n_splits) {
  const int bk = blockIdx.x;
  for (int e = threadIdx.x; e < g * d; e += THREADS) {
    const int r = e / d;
    const size_t base = (size_t)bk * n_splits;
    float m_glob = ATTN_NEG;
    for (int s = 0; s < n_splits; ++s)
      m_glob = fmaxf(m_glob, m_in[(base + s) * g + r]);
    float l_glob = 0.f, num = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = expf(m_in[(base + s) * g + r] - m_glob);
      l_glob += l_in[(base + s) * g + r] * w;
      num += acc_in[(base + s) * g * d + e] * w;
    }
    // o [B, 1, H, D] with h = kh * g + r: row bk's g heads are contiguous
    o[(size_t)bk * g * d + e] = from_float<T>(num / fmaxf(l_glob, 1e-30f));
  }
}

template <typename T, int D, int GP>
cudaError_t launch_split(const T* q, const T* kc, const T* vc,
                         const int* pos, float* m, float* l, float* acc,
                         int n_b, int seq, int n_kv_heads, int g,
                         int n_splits, float scale, cudaStream_t st) {
  const dim3 grid(n_b * n_kv_heads, n_splits);
  decode_split<T, D, GP><<<grid, THREADS, 0, st>>>(
      q, kc, vc, pos, m, l, acc, seq, n_kv_heads, g, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dim(const T* q, const T* kc, const T* vc, const int* pos,
                       float* m, float* l, float* acc, T* o, int n_b, int seq,
                       int n_kv_heads, int g, int n_splits, float scale,
                       cudaStream_t st) {
  cudaError_t err;
  if (g <= 1)
    err = launch_split<T, D, 1>(q, kc, vc, pos, m, l, acc, n_b, seq,
                                n_kv_heads, g, n_splits, scale, st);
  else if (g <= 2)
    err = launch_split<T, D, 2>(q, kc, vc, pos, m, l, acc, n_b, seq,
                                n_kv_heads, g, n_splits, scale, st);
  else if (g <= 4)
    err = launch_split<T, D, 4>(q, kc, vc, pos, m, l, acc, n_b, seq,
                                n_kv_heads, g, n_splits, scale, st);
  else
    err = launch_split<T, D, 8>(q, kc, vc, pos, m, l, acc, n_b, seq,
                                n_kv_heads, g, n_splits, scale, st);
  if (err != cudaSuccess) return err;
  decode_combine<T><<<n_b * n_kv_heads, THREADS, 0, st>>>(m, l, acc, o, g, D,
                                                          n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* pos, float* m, float* l, float* acc, void* o,
                   int n_b, int seq, int n_kv_heads, int g, int d,
                   int n_splits, float scale, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(kc);
  const T* vt = static_cast<const T*>(vc);
  T* ot = static_cast<T*>(o);
#define PANDADB_DECODE(DIM)                                                   \
  case DIM:                                                                   \
    return launch_dim<T, DIM>(qt, kt, vt, pos, m, l, acc, ot, n_b, seq,       \
                              n_kv_heads, g, n_splits, scale, st);
  switch (d) {
    PANDADB_DECODE(16)
    PANDADB_DECODE(32)
    PANDADB_DECODE(64)
    PANDADB_DECODE(128)
    PANDADB_DECODE(160)
    default:
      return cudaErrorInvalidValue;
  }
#undef PANDADB_DECODE
}

}  // namespace

// q [n_b, 1, n_kv_heads * g, d], k_cache and v_cache [n_b, seq, n_kv_heads,
// d], o like q, all contiguous, of type dtype (0 float32, 1 bfloat16); pos
// [n_b] int32 >= 0.  m and l hold n_b * n_kv_heads * n_splits * g floats,
// acc that times d: the splits' partials.  Returns cudaError_t.
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const int* pos,
                                float* m, float* l, float* acc, void* o,
                                int n_b, int seq, int n_kv_heads, int g,
                                int d, int dtype, int n_splits, float scale,
                                void* stream) {
  if (n_b <= 0) return 0;
  if (seq <= 0 || n_kv_heads <= 0 || g < 1 || g > MAX_G || n_splits < 1 ||
      n_splits > MAX_GRID_Y)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == pandadb::DTYPE_F32)
    return (int)launch<float>(q, k_cache, v_cache, pos, m, l, acc, o, n_b,
                              seq, n_kv_heads, g, d, n_splits, scale, st);
  if (dtype == pandadb::DTYPE_BF16)
    return (int)launch<__nv_bfloat16>(q, k_cache, v_cache, pos, m, l, acc, o,
                                      n_b, seq, n_kv_heads, g, d, n_splits,
                                      scale, st);
  return (int)cudaErrorInvalidValue;
}
