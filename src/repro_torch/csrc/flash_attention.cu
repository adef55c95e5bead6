// flash_attention: causal (or full) attention with an online softmax, for
// Hopper.
//
// Replaces the Pallas kernel flash_attention_pallas (body _flash_kernel) of
// src/repro/kernels/flash_attention/flash_attention.py, and with it the
// reference model's chunked_attention (src/repro/models/attention.py), its
// XLA form.  q [B, S, H, D], k and v [B, S, KVH, D] with KVH dividing H:
// query head h reads key head h / (H / KVH) in place, so grouped-query
// attention needs no repeat_kv copy of k and v.  Scores are q . k * scale in
// float32; masked scores are -1e30 (not -inf, so a fully masked tile keeps a
// finite max); m, l and the accumulator are float32; l is floored at 1e-30;
// the output is in q's type.  With bf16_probs the softmax weights are
// rounded to bfloat16 before P.V (l sums them unrounded), as
// chunked_attention does.  Any S runs: keys and rows past S are masked, with
// no fallback to another path.  Key tiles past the causal diagonal of a
// query tile are not loaded at all (the Pallas kernel's `run` skip), and the
// heaviest query tiles start first so the short ones fill the tail.
//
// Bound: at the prefill's shapes (S = 4,096, D = 128) attention does
// 2 B H S^2 D causal operations on 2 B S (H + 2 KVH) D bytes, so it is bound
// by operations, at the bf16 tensor-core rate for bf16 inputs.  Two paths:
//
// * bfloat16 (the LM's type): tensor-core tiles, mma.sync m16n8k16 with
//   float32 accumulation.  A block of four warps holds 64 query rows, 16 a
//   warp, whose q fragments stay in registers; K and V tiles of 32 keys are
//   copied to shared memory with 16-byte loads (rows padded by 16 bytes so
//   ldmatrix reads them without bank conflicts; V through ldmatrix.trans).
//   S = Q K^T and the online softmax stay in registers, and the softmax
//   weights become the A fragments of P.V directly.  bf16 products of bf16
//   inputs are exact in float32, so Q K^T is the float32 score.  P is
//   float32, which the tensor cores do not take: it goes in as two bf16
//   terms, hi = bf16(p) and lo = bf16(p - hi), so each weight keeps 16 bits
//   (relative error <= 2^-16); with bf16_probs only hi goes in, which is
//   exactly the rounding chunked_attention applies.
// * float32 (the parity configs): float32 FMAs on the SIMT cores, since
//   TF32 tensor cores would change the scores.  Four threads per query row,
//   each with a quarter of the row's scaled q and accumulator in registers
//   as float4 chunks; K and V tiles of 32 keys in shared memory; a row's
//   score is its four threads' partial dots summed by two warp shuffles.
#include "attention_dtype.cuh"

namespace {

using pandadb::ATTN_NEG;

constexpr int BQ = 64;                // query rows per block
constexpr int BK = 32;                // keys per shared tile
constexpr int LANES = 4;              // threads per query row
constexpr int THREADS = BQ * LANES;   // 256
constexpr int MAX_GRID = 65535;

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

using bf16 = __nv_bfloat16;

constexpr int MQ = 64;                // query rows per block, 16 per warp
constexpr int MK = 32;                // keys per shared tile
constexpr int MTHREADS = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// two floats as one bf16x2 register, the first in the low half (the lower
// column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
__global__ void __launch_bounds__(MTHREADS)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int seq,
              int n_heads, int n_kv_heads, float scale, int causal,
              int bf16_probs) {
  constexpr int KS = D / 16;          // k-steps of Q K^T
  constexpr int NT = D / 8;           // n-tiles of the P.V output
  constexpr int ST = MK / 8;          // n-tiles of a score tile
  constexpr int LD = D + 8;           // shared row stride in bf16
  __shared__ __align__(16) bf16 ks[MK * LD];
  __shared__ __align__(16) bf16 vs[MK * LD];

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (n_heads / n_kv_heads);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;                     // fragment row in 0..7
  const int t4 = lane % 4;
  const int q0 = qt * MQ + warp * 16;          // this warp's first row
  const int r0 = q0 + gr;                      // the two rows this thread
  const int r1 = r0 + 8;                       // holds in C fragments

  const size_t row_stride = (size_t)n_heads * D;
  const bf16* qb = q + ((size_t)b * seq * n_heads + h) * D;
  uint32_t qa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c = s * 16 + t4 * 2;
    const uint32_t* p0 =
        reinterpret_cast<const uint32_t*>(qb + (size_t)r0 * row_stride + c);
    const uint32_t* p1 =
        reinterpret_cast<const uint32_t*>(qb + (size_t)r1 * row_stride + c);
    qa[s][0] = r0 < seq ? p0[0] : 0u;
    qa[s][1] = r1 < seq ? p1[0] : 0u;
    qa[s][2] = r0 < seq ? p0[4] : 0u;          // columns c + 8, c + 9
    qa[s][3] = r1 < seq ? p1[4] : 0u;
  }

  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = ATTN_NEG, m1 = ATTN_NEG, l0 = 0.f, l1 = 0.f;

  const int k_end = causal ? min(seq, (qt + 1) * MQ) : seq;
  const size_t pos_stride = (size_t)n_kv_heads * D;
  const size_t kv_base = ((size_t)b * seq * n_kv_heads + kh) * D;
  const int mat = lane / 8;                    // ldmatrix: this lane's
  const int mrow = lane % 8;                   // matrix and row

  for (int k0 = 0; k0 < k_end; k0 += MK) {
    __syncthreads();                           // the last tile has been read
    for (int e = threadIdx.x; e < MK * (D / 8); e += MTHREADS) {
      const int j = e / (D / 8);
      const int c = (e - j * (D / 8)) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = kx;
      if (k0 + j < seq) {
        const size_t off = kv_base + (size_t)(k0 + j) * pos_stride + c;
        kx = *reinterpret_cast<const uint4*>(k + off);
        vx = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + j * LD + c) = kx;
      *reinterpret_cast<uint4*>(vs + j * LD + c) = vx;
    }
    __syncthreads();
    if (causal && k0 > q0 + 15) continue;      // wholly above this warp's rows

    float sc[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
        // matrices: keys +0..7 / +8..15 of this pair, dims s*16 + 0..7 / 8..15
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (np * 16 + (mat / 2) * 8 + mrow) * LD + s * 16 +
                            (mat % 2) * 8);
        mma_bf16(sc[2 * np], qa[s], kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qa[s], kb[2], kb[3]);
      }
    }

    float mx0 = ATTN_NEG, mx1 = ATTN_NEG;
#pragma unroll
    for (int n = 0; n < ST; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + t4 * 2 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool ok = key < seq && (!causal || key <= row);
        sc[n][e] = ok ? sc[n][e] * scale : ATTN_NEG;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w *= 2) {           // the row's four threads
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < ST; ++n) {
      sc[n][0] = expf(sc[n][0] - mn0);
      sc[n][1] = expf(sc[n][1] - mn0);
      sc[n][2] = expf(sc[n][2] - mn1);
      sc[n][3] = expf(sc[n][3] - mn1);
      ps0 += sc[n][0] + sc[n][1];
      ps1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * a0 + ps0;                        // this thread's columns; the
    l1 = l1 * a1 + ps1;                        // quad sums them at the end
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      oacc[n][0] *= a0;
      oacc[n][1] *= a0;
      oacc[n][2] *= a1;
      oacc[n][3] *= a1;
    }

#pragma unroll
    for (int j = 0; j < MK / 16; ++j) {
      // the score tiles 2j, 2j + 1 are the A fragment of keys 16j..16j+15
      const float* x = sc[2 * j];
      const float* y = sc[2 * j + 1];
      uint32_t hi[4] = {pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                        pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3])};
      uint32_t lo[4] = {0u, 0u, 0u, 0u};
      if (!bf16_probs) {
        lo[0] = pack_bf16(x[0] - bf16_round(x[0]), x[1] - bf16_round(x[1]));
        lo[1] = pack_bf16(x[2] - bf16_round(x[2]), x[3] - bf16_round(x[3]));
        lo[2] = pack_bf16(y[0] - bf16_round(y[0]), y[1] - bf16_round(y[1]));
        lo[3] = pack_bf16(y[2] - bf16_round(y[2]), y[3] - bf16_round(y[3]));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // matrices: keys 16j + 0..7 / 8..15, dims np*16 + 0..7 / 8..15
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (j * 16 + (mat % 2) * 8 + mrow) * LD +
                                  np * 16 + (mat / 2) * 8);
        mma_bf16(oacc[2 * np], hi, vb[0], vb[1]);
        mma_bf16(oacc[2 * np + 1], hi, vb[2], vb[3]);
        if (!bf16_probs) {
          mma_bf16(oacc[2 * np], lo, vb[0], vb[1]);
          mma_bf16(oacc[2 * np + 1], lo, vb[2], vb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int w = 1; w < 4; w *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = o + ((size_t)b * seq * n_heads + h) * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + t4 * 2;
    if (r0 < seq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * row_stride + c) =
          pack_bf16(oacc[n][0] * inv0, oacc[n][1] * inv0);
    if (r1 < seq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * row_stride + c) =
          pack_bf16(oacc[n][2] * inv1, oacc[n][3] * inv1);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int seq,
          int n_heads, int n_kv_heads, float scale, int causal,
          int bf16_probs) {
  constexpr int C = D / (4 * LANES);  // float4 chunks per thread
  __shared__ float4 ks[BK][D / 4];
  __shared__ float4 vs[BK][D / 4];

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (n_heads / n_kv_heads);
  const int row = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const int qp = qt * BQ + row;                // this row's query position
  const bool live = qp < seq;

  float4 qr[C], acc[C];
  const size_t q_off = (((size_t)b * seq + qp) * n_heads + h) * D;
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
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = ATTN_NEG, l = 0.f;

  const int k_end = causal ? min(seq, (qt + 1) * BQ) : seq;
  const size_t pos_stride = (size_t)n_kv_heads * D;
  const size_t kv_base = ((size_t)b * seq * n_kv_heads + kh) * D;
  float* ksf = reinterpret_cast<float*>(ks);
  float* vsf = reinterpret_cast<float*>(vs);

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                       // the last tile has been read
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int j = e / D;
      const int d = e - j * D;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < seq) {
        const size_t off = kv_base + (size_t)(k0 + j) * pos_stride + d;
        kx = k[off];
        vx = v[off];
      }
      ksf[e] = kx;
      vsf[e] = vx;
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
      const bool ok = kp < seq && (!causal || kp <= qp);
      sc[j] = ok ? part : ATTN_NEG;
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
    for (int c = 0; c < C; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = sc[j];
#pragma unroll
      for (int c = 0; c < C; ++c) {
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
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d = 4 * (lane + c * LANES);
    o[q_off + d] = acc[c].x * inv;
    o[q_off + d + 1] = acc[c].y * inv;
    o[q_off + d + 2] = acc[c].z * inv;
    o[q_off + d + 3] = acc[c].w * inv;
  }
}

cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* o, int n_b, int seq, int n_heads,
                       int n_kv_heads, int d, float scale, int causal,
                       int bf16_probs, cudaStream_t st) {
  const dim3 grid((seq + BQ - 1) / BQ, n_heads, n_b);
#define PANDADB_FLASH(DIM)                                                    \
  case DIM:                                                                   \
    flash_fwd<DIM><<<grid, THREADS, 0, st>>>(                          \
        q, k, v, o, seq, n_heads, n_kv_heads, scale, causal, bf16_probs);     \
    break;
  switch (d) {
    PANDADB_FLASH(16)
    PANDADB_FLASH(32)
    PANDADB_FLASH(64)
    PANDADB_FLASH(128)
    PANDADB_FLASH(160)
    default:
      return cudaErrorInvalidValue;
  }
#undef PANDADB_FLASH
  return cudaGetLastError();
}

cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                        int n_b, int seq, int n_heads, int n_kv_heads, int d,
                        float scale, int causal, int bf16_probs,
                        cudaStream_t st) {
  const dim3 grid((seq + MQ - 1) / MQ, n_heads, n_b);
#define PANDADB_FLASH(DIM)                                                    \
  case DIM:                                                                   \
    flash_fwd_mma<DIM><<<grid, MTHREADS, 0, st>>>(                            \
        q, k, v, o, seq, n_heads, n_kv_heads, scale, causal, bf16_probs);     \
    break;
  switch (d) {
    PANDADB_FLASH(16)
    PANDADB_FLASH(32)
    PANDADB_FLASH(64)
    PANDADB_FLASH(128)
    PANDADB_FLASH(160)
    default:
      return cudaErrorInvalidValue;
  }
#undef PANDADB_FLASH
  return cudaGetLastError();
}

}  // namespace

// q [n_b, seq, n_heads, d], k and v [n_b, seq, n_kv_heads, d], o like q, all
// contiguous, of type dtype (0 float32, 1 bfloat16; bfloat16 pointers
// 16-byte aligned); d in {16, 32, 64, 128, 160}.  Returns cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int n_b, int seq, int n_heads,
                               int n_kv_heads, int d, int dtype, float scale,
                               int causal, int bf16_probs, void* stream) {
  if (n_b <= 0 || seq <= 0) return 0;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || n_heads > MAX_GRID ||
      n_b > MAX_GRID)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == pandadb::DTYPE_F32)
    return (int)launch_f32(static_cast<const float*>(q),
                           static_cast<const float*>(k),
                           static_cast<const float*>(v),
                           static_cast<float*>(o), n_b, seq, n_heads,
                           n_kv_heads, d, scale, causal, bf16_probs, st);
  if (dtype == pandadb::DTYPE_BF16)
    return (int)launch_bf16(static_cast<const bf16*>(q),
                            static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), static_cast<bf16*>(o),
                            n_b, seq, n_heads, n_kv_heads, d, scale, causal,
                            bf16_probs, st);
  return (int)cudaErrorInvalidValue;
}
