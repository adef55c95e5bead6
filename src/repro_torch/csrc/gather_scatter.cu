// gather_scatter: the GNN family's SpMM, one message-passing aggregation,
// for Hopper.
//
//   out[v] = sum_{e: dst[e] = v} w[e] * x[src[e]]        (reduce "sum")
//   out[v] = that sum / max(count_v, 1)                  (reduce "mean")
//
// Replaces no Pallas kernel: the reference computes it with XLA's gather and
// jax.ops.segment_sum (gather_scatter, src/repro/models/gnn/common.py:37),
// which materialise the [E, d] message tensor, and its weighted copy, in
// device memory; eager PyTorch would do the same before index_add_.  At
// ogb_products' shape (61.9M edges, d = 100 and 128, float32) that is 2 x
// 24.7 and 2 x 31.7 GB a layer.  This kernel builds none of it.
//
// Input: x [n_x, d] (float32 or bf16, trailing dims flattened by the
// wrapper), and the edges as a CSR by destination: ptr [n_rows + 1] int64
// offsets, col [E] int32 source rows, w [E] float32 weights (nullable: every
// weight 1), all in the order of a stable sort of the edges by destination,
// so each row's edges come in their original order.  count_v is
// ptr[v + 1] - ptr[v]: every edge into v, weight 0 (masked) or not, as the
// reference's segment_mean counts them.
//
// Design (the first, simple one): one warp a destination row, which sums
// the row TILE = 128 columns at a time.  The warp loads 32 of the row's
// (col, w) pairs at a time, one a lane, and walks them in order by
// shuffles; each lane sums its 4 columns of the tile in float32 registers
// (one float4 where d % 4 == 0, two float2 where d % 2 == 0, else four
// scalars) and writes them once: no atomics, no scratch, the same result on
// every run.  Where the rows alone give fewer than FILL_WARPS warps (Cora:
// 2,708 rows of 1,433 features), the grid's y dimension also splits each
// row's column tiles over warps, which then walk the row's edges each.
// Products and sums are __fmul_rn / __fadd_rn, never contracted into an
// FMA, so a row's sum is the plain version's ((0 + w0 x0) + w1 x1) + ... in
// edge order: a CPU index_add_ adds in the same order, and the two agree
// bit for bit.  The mean divides with __fdiv_rn, as the plain version's
// true division.
// bf16 input is widened exactly and summed in float32; bf16 output is
// rounded once at the store (the reference rounds at every add).
//
// Bound: bytes.  The kernel does 2 operations an element of a message; each
// message row is a random gather of d x 4 bytes.  The least the card could
// move is every input read once and the output written once (n_x d + n d
// elements, plus 8 bytes an edge for col and w); the gather floor, every
// message row read from memory, is E d elements more.  Power-law sources
// leave much of the gather to the 50 MB L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;        // destination rows a block (one a warp)
constexpr int TILE = 128;       // columns a warp sums at a time
// warps that fill an H100 four times over (132 SMs x 64 resident warps):
// fewer rows than this split their column tiles over warps
constexpr int FILL_WARPS = 132 * 64 * 4;
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC consecutive elements of x (aligned to VEC elements) as float32
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int q = 0; q < VEC; ++q) out[q] = widen(pk.v[q]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int q = 0; q < VEC; ++q) pk.v[q] = narrow<T>(in[q]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
gather_scatter_rows(const Tin* __restrict__ x, Tout* __restrict__ out,
                    const long long* __restrict__ ptr,
                    const int* __restrict__ col,
                    const float* __restrict__ w, int n_rows, int d,
                    int mean) {
  constexpr int PER = TILE / (32 * VEC);        // vectors a lane
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;                    // whole warps leave
  const long long begin = ptr[row];
  const long long end = ptr[row + 1];
  const float denom = (float)(end - begin > 1 ? end - begin : 1);
  for (int base = blockIdx.y * TILE; base < d; base += gridDim.y * TILE) {
    float acc[PER][VEC];
#pragma unroll
    for (int p = 0; p < PER; ++p)
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[p][q] = 0.0f;
    for (long long e0 = begin; e0 < end; e0 += 32) {
      const int n = (int)(end - e0 < 32 ? end - e0 : 32);
      int my_col = 0;
      float my_w = 1.0f;
      if (lane < n) {
        my_col = col[e0 + lane];
        if (w != nullptr) my_w = w[e0 + lane];
      }
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int s = __shfl_sync(FULL, my_col, j);
        const float wj = __shfl_sync(FULL, my_w, j);
        const Tin* xr = x + (size_t)s * d;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const int c = base + (p * 32 + lane) * VEC;
          if (c < d) {                           // d % VEC == 0
            float v[VEC];
            load_vec<Tin, VEC>(xr + c, v);
#pragma unroll
            for (int q = 0; q < VEC; ++q)
              acc[p][q] = __fadd_rn(acc[p][q], __fmul_rn(wj, v[q]));
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = base + (p * 32 + lane) * VEC;
      if (c < d) {
        if (mean) {
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[p][q] = __fdiv_rn(acc[p][q], denom);
        }
        store_vec<Tout, VEC>(out + (size_t)row * d + c, acc[p]);
      }
    }
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, void* out, const long long* ptr, const int* col,
           const float* w, int n_rows, int d, int mean, cudaStream_t stream) {
  // the widest vector that divides d and both base pointers' alignment
  const size_t align = (size_t)x | (size_t)out;
  const size_t big = sizeof(Tin) > sizeof(Tout) ? sizeof(Tin) : sizeof(Tout);
  const int tiles = (d + TILE - 1) / TILE;
  const int split = n_rows >= FILL_WARPS ? 1 : FILL_WARPS / n_rows;
  const dim3 grid((unsigned)((n_rows + WARPS - 1) / WARPS),
                  (unsigned)(tiles < split ? tiles : split));
  const Tin* xi = static_cast<const Tin*>(x);
  Tout* o = static_cast<Tout*>(out);
  if (d % 4 == 0 && align % (4 * big) == 0) {
    gather_scatter_rows<Tin, Tout, 4><<<grid, WARPS * 32, 0, stream>>>(
        xi, o, ptr, col, w, n_rows, d, mean);
  } else if (d % 2 == 0 && align % (2 * big) == 0) {
    gather_scatter_rows<Tin, Tout, 2><<<grid, WARPS * 32, 0, stream>>>(
        xi, o, ptr, col, w, n_rows, d, mean);
  } else {
    gather_scatter_rows<Tin, Tout, 1><<<grid, WARPS * 32, 0, stream>>>(
        xi, o, ptr, col, w, n_rows, d, mean);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [n_x, d] (float32, or bf16 when x_bf16), out [n_rows, d] (float32, or
// bf16 when out_bf16), the CSR by destination (ptr [n_rows + 1] int64, col
// [E] int32), w [E] float32 or null; mean != 0 divides each row by
// max(count, 1).  Returns the launch's cudaError_t.
extern "C" int gather_scatter(const void* x, int x_bf16, void* out,
                              int out_bf16, const long long* ptr,
                              const int* col, const float* w, int n_rows,
                              int d, int mean, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(
                          x, out, ptr, col, w, n_rows, d, mean, s)
                    : launch<__nv_bfloat16, float>(x, out, ptr, col, w,
                                                   n_rows, d, mean, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(x, out, ptr, col, w, n_rows,
                                                 d, mean, s)
                  : launch<float, float>(x, out, ptr, col, w, n_rows, d,
                                         mean, s);
}
