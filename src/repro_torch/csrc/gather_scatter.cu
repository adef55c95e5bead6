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
// reference's segment_mean counts them.  The gradient of x is the same
// kernel over the CSR by source, with `scale` [n_x] float32 (the forward's
// counts) for the mean: each edge's weight is then w[e] / max(scale[col],
// 1), divided here, as the plain version divides it.
//
// Bound: bytes.  The kernel does 2 operations an element of a message; each
// message row is a random gather of d x 4 bytes.  The least the card could
// move is every input read once and the output written once (n_x d + n d
// elements, plus 8 bytes an edge for col and w): that bound only a
// renumbering of the nodes, so that a row's sources share lines, would
// approach.  The gather floor, every message row read once from memory, is
// E d elements more; power-law sources leave part of it to the L1 and the
// 50 MB L2, and random rows of a few hundred bytes keep the memory below
// its peak rate.  What the design does about the floor is keep enough rows
// in flight to run at the memory's rate for random rows, and every warp
// busy to the end:
//
// - An asynchronous row pipeline.  Each warp stages its message rows in a
//   ring in shared memory, RING = 16 rows of a 128-column tile deep (512 B
//   a row in float32), filled by cp.async through L1: each lane copies,
//   and later reads back, only its own 4 columns of each row, so no
//   barrier is needed, and one mechanism serves every width (16, 8 and
//   4-byte copies; a bulk copy would need rows of a multiple of 16 bytes).
//   The edges' (col, w) pairs are loaded up to three batches of 32 ahead
//   and the mean's count of each col two ahead, so no load stalls the
//   sums.  A warp streams the edges of a run of consecutive rows as one
//   pipeline and writes each row as its last edge is summed, so short rows
//   do not drain the ring.
// - Long rows first, split by columns.  Rows of at least `long_min` edges
//   (the wrapper's threshold; the backward's hub sources under power-law
//   graphs have tens of thousands) are listed by the wrapper, with no host
//   sync, and taken before any short row; each is split into column slices
//   of 32 lanes x 4 bytes, a warp a slice, each walking every edge of the
//   row, 32 rows deep.  Warps are persistent: each takes its first work
//   item by its index and the rest from an atomic counter that the CSR
//   keeps; a launch's last add sets it back to 0, so no launch clears it.
// - Edge order.  Every column's sum is ((0 + w0 x0) + w1 x1) + ... in edge
//   order, in __fmul_rn / __fadd_rn, never contracted into an FMA, whatever
//   warp sums it and whatever order the rows are taken in: a CPU
//   index_add_ adds in the same order, and the two agree bit for bit.  The
//   mean divides with __fdiv_rn, as the plain version's true division.
//   bf16 input is widened exactly and summed in float32; bf16 output is
//   rounded once at the store (the reference rounds at every add).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using pandadb::cp_async_commit;
using pandadb::cp_async_wait;
using pandadb::smem_addr;

constexpr int WARPS = 8;         // warps a block, each on its own work
constexpr int TILE = 128;        // columns a short row's warp sums at a time
constexpr int RING = 16;         // message rows in flight a warp, short rows
constexpr int RING_LONG = 32;    // the same for a long row's column slice
constexpr int CHUNK = 32;        // most consecutive short rows a work item
constexpr int CHUNK_MANY = 8;    // the same where every warp takes several
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* x;
  void* out;
  const long long* ptr;
  const int* col;
  const float* w;                 // nullable: every weight 1
  const float* scale;             // nullable: the mean's counts, by col
  const int* long_rows;           // the rows of >= long_min edges, first
  const int* n_long;              // of them (one int on the card)
  unsigned long long* work;       // the work counter, 0 between launches
  long long n_chunks;
  int n_rows, d, mean, long_min, chunk, tiles, slices;
};

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

// VEC elements of a message row into this lane's slot of the ring:
// cp.async of 16, 8 or 4 bytes, through L1 (hub rows hit there); 2 bytes
// (bf16 at an odd width) by a plain load, which cp.async cannot copy
template <typename T, int VEC>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  constexpr int B = VEC * (int)sizeof(T);
  if constexpr (B >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(B) : "memory");
  } else {
    *dst = *src;
  }
}

// One lane's edge of a batch of 32: its source row, its weight, and the
// mean's count of that row (the backward's scale; 1 without).
struct Edge {
  unsigned c;
  float w, s;
  bool valid;
};

// the loads of the walk's edge k that need no other load
__device__ __forceinline__ Edge edge_load(const int* col, const float* w,
                                          int k, int len) {
  Edge r{0u, 1.0f, 1.0f, k < len};
  if (r.valid) {
    r.c = (unsigned)col[k];
    if (w != nullptr) r.w = w[k];
  }
  return r;
}

// the count of the edge's row, issued a batch before its use: nothing is
// computed from it here, so nothing waits for it
__device__ __forceinline__ void edge_lookup(const Args& a, Edge& r) {
  if (r.valid && a.scale != nullptr) r.s = a.scale[r.c];
}

// the weight as the sums use it: w / max(count, 1), the same bits as the
// plain version's division
__device__ __forceinline__ Edge edge_ready(const Args& a, Edge r) {
  if (a.scale != nullptr) r.w = __fdiv_rn(r.w, fmaxf(r.s, 1.0f));
  return r;
}

// Sums rows [row0, row0 + nrows), whose edges are the len edges from eb on
// in CSR order, over the columns [c0, c0 + 32 VEC PER) of d that this
// warp's lanes hold (VEC consecutive columns a lane, PER such groups 32 VEC
// apart), and writes each row when its last edge is summed.  `ends`: lane
// off + i holds row0 + i's end.  The ring holds S message rows of the
// slice.  Edge positions inside the walk are ints (a walk is one CSR's
// rows, under 2^31 edges).
template <typename Tin, typename Tout, int VEC, int PER, int S>
__device__ __forceinline__ void walk(const Args& a, Tin* ring, long long eb,
                                     int len, long long ends, int row0,
                                     int nrows, int off, int c0) {
  static_assert(S <= 32 && (S & (S - 1)) == 0, "S divides a batch of 32");
  const int lane = threadIdx.x & 31;
  const Tin* x = static_cast<const Tin*>(a.x);
  Tout* out = static_cast<Tout*>(a.out);
  const int* col = a.col + eb;
  const float* w = a.w != nullptr ? a.w + eb : nullptr;
  const int d = a.d;
  const int cend = min(c0 + 32 * VEC * PER, d);
  float acc[PER][VEC];
#pragma unroll
  for (int p = 0; p < PER; ++p)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[p][q] = 0.0f;

  // edge k of the walk into slot k % S
  auto issue = [&](int s, unsigned cj) {
    const Tin* xr = x + (size_t)cj * d;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = c0 + (p * 32 + lane) * VEC;
      if (c < cend)
        stage<Tin, VEC>(ring + ((s * PER + p) * 32 + lane) * VEC, xr + c);
    }
  };
  auto flush = [&](int row, int cnt) {
    const float denom = (float)(cnt > 1 ? cnt : 1);
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = c0 + (p * 32 + lane) * VEC;
      if (c < cend) {
        if (a.mean) {
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[p][q] = __fdiv_rn(acc[p][q], denom);
        }
        store_vec<Tout, VEC>(out + (size_t)row * d + c, acc[p]);
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[p][q] = 0.0f;
    }
  };

  // batches of 32 edges: cur ready, nxt with its counts in flight, raw
  // loaded; the loop looks up raw's counts a batch ahead of their use
  Edge cur = edge_load(col, w, lane, len);
  Edge nxt = edge_load(col, w, 32 + lane, len);
  Edge raw = edge_load(col, w, 64 + lane, len);
  edge_lookup(a, cur);
  edge_lookup(a, nxt);
  cur = edge_ready(a, cur);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const unsigned ci = __shfl_sync(FULL, cur.c, i);
    if (i < len) issue(i, ci);
    cp_async_commit();
  }
  int r = 0, rs = 0;
  int nb = (int)(__shfl_sync(FULL, ends, off) - eb);
  for (int base = 0; base < len; base += 32) {
    Edge nn = raw;
    edge_lookup(a, nn);
    raw = edge_load(col, w, base + 96 + lane, len);
    const int m = min(32, len - base);
    const int left = min(64, len - base);      // edges from base on
    for (int t = 0; t < m; ++t) {
      const int j = base + t;
      while (j == nb) {                 // rows before edge j are complete
        flush(row0 + r, nb - rs);
        ++r;
        rs = nb;
        nb = (int)(__shfl_sync(FULL, ends, off + r) - eb);
      }
      cp_async_wait<S - 1>();           // edge j's row has landed
      const float wj = __shfl_sync(FULL, cur.w, t);
      const int s = t & (S - 1);
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int c = c0 + (p * 32 + lane) * VEC;
        if (c < cend) {
          float v[VEC];
          load_vec<Tin, VEC>(ring + ((s * PER + p) * 32 + lane) * VEC, v);
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            acc[p][q] = __fadd_rn(acc[p][q], __fmul_rn(wj, v[q]));
        }
      }
      // refill the slot with edge j + S
      const int u = t + S;
      const unsigned cj = __shfl_sync(FULL, u < 32 ? cur.c : nxt.c, u & 31);
      if (u < left) issue(s, cj);
      cp_async_commit();
    }
    cur = edge_ready(a, nxt);
    nxt = nn;
  }
  for (; r < nrows; ++r) {             // the last row, and empty ones after
    flush(row0 + r, nb - rs);
    rs = nb;
    if (r + 1 < nrows) nb = (int)(__shfl_sync(FULL, ends, off + r + 1) - eb);
  }
}

template <typename Tin, int VEC>
__host__ __device__ constexpr int long_vec() {  // a long row's columns a lane
  return VEC * (int)sizeof(Tin) >= 4 ? 4 / (int)sizeof(Tin) : 1;
}

template <typename Tin>
__host__ __device__ constexpr int ring_bytes() {  // a warp's ring
  return RING * TILE * (int)sizeof(Tin);
}

// three blocks an SM: their rings fill the shared memory, so the registers
// need not be held to fewer
template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(WARPS * 32, 3)
gather_scatter_rows(const Args a) {
  constexpr int PER = TILE / (32 * VEC);
  constexpr int LV = long_vec<Tin, VEC>();
  static_assert(RING_LONG * 32 * LV <= RING * TILE, "long ring fits");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  Tin* ring = reinterpret_cast<Tin*>(smem + (threadIdx.x >> 5) *
                                     ring_bytes<Tin>());
  const long long long_items = (long long)*a.n_long * a.slices;
  const long long total = long_items + a.n_chunks * a.tiles;
  // the first item by the warp's index, the rest from the counter
  const long long warps = (long long)gridDim.x * WARPS;
  long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  unsigned long long mine = 0;
  while (item < total) {
    if (lane == 0) {
      mine = atomicAdd(a.work, 1ull);   // the next, in flight
      // a launch adds `total` times: the last add leaves 0 for the next
      if (mine == (unsigned long long)total - 1) atomicExch(a.work, 0ull);
    }
    if (item < long_items) {
      // one column slice of a long row
      const int row = a.long_rows[item / a.slices];
      const int c0 = (int)(item % a.slices) * 32 * LV;
      const long long eb = a.ptr[row], ee = a.ptr[row + 1];
      walk<Tin, Tout, LV, 1, RING_LONG>(a, ring, eb, (int)(ee - eb), ee, row,
                                        1, 0, c0);
    } else {
      // one column tile of up to CHUNK consecutive rows, long ones left out
      const long long k = item - long_items;
      const int c0 = (int)(k % a.tiles) * TILE;
      const long long r0 = (k / a.tiles) * a.chunk;
      const int nr = (int)min((long long)a.chunk, a.n_rows - r0);
      long long s = 0, e = 0;
      if (lane < nr) {
        s = a.ptr[r0 + lane];
        e = a.ptr[r0 + lane + 1];
      }
      const unsigned longs = __ballot_sync(FULL, lane < nr &&
                                           e - s >= a.long_min);
      for (int i = 0; i < nr;) {
        const unsigned rest = longs >> i;
        if (rest & 1u) {
          ++i;
          continue;
        }
        const int len = rest ? min(__ffs(rest) - 1, nr - i) : nr - i;
        const long long eb = __shfl_sync(FULL, s, i);
        const long long ee = __shfl_sync(FULL, e, i + len - 1);
        walk<Tin, Tout, VEC, PER, RING>(a, ring, eb, (int)(ee - eb), e,
                                        (int)r0 + i, len, i, c0);
        i += len;
      }
    }
    item = warps + (long long)__shfl_sync(FULL, mine, 0);
  }
}

template <typename Tin, typename Tout, int VEC>
int launch_vec(Args a, long long n_edges, cudaStream_t stream) {
  auto kern = gather_scatter_rows<Tin, Tout, VEC>;
  constexpr int smem = WARPS * ring_bytes<Tin>();
  static int per_sm = 0;                 // resident blocks an SM
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        WARPS * 32, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long warps = (long long)per_sm * sms * WARPS;
  constexpr int LV = long_vec<Tin, VEC>();
  a.tiles = (a.d + TILE - 1) / TILE;
  a.slices = (a.d + 32 * LV - 1) / (32 * LV);
  // rows an item: as few as give every resident warp one item (Cora:
  // 2,708 rows of 12 tiles take 11), up to CHUNK; past that every warp
  // takes several, and the last ones end the launch, so they are short
  const long long fill = ((long long)a.n_rows * a.tiles + warps - 1) / warps;
  a.chunk = (int)(fill > CHUNK ? CHUNK_MANY : fill);
  a.n_chunks = (a.n_rows + a.chunk - 1) / a.chunk;
  long long longs = n_edges / (a.long_min > 0 ? a.long_min : 1);
  if (longs > a.n_rows) longs = a.n_rows;
  const long long items = a.n_chunks * a.tiles + longs * a.slices;
  long long grid = (items + WARPS - 1) / WARPS;
  if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
  kern<<<(unsigned)grid, WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch(const Args& a, long long n_edges, cudaStream_t stream) {
  // the widest vector that divides d and both base pointers' alignment
  const size_t align = (size_t)a.x | (size_t)a.out;
  const size_t big = sizeof(Tin) > sizeof(Tout) ? sizeof(Tin) : sizeof(Tout);
  if (a.d % 4 == 0 && align % (4 * big) == 0)
    return launch_vec<Tin, Tout, 4>(a, n_edges, stream);
  if (a.d % 2 == 0 && align % (2 * big) == 0)
    return launch_vec<Tin, Tout, 2>(a, n_edges, stream);
  return launch_vec<Tin, Tout, 1>(a, n_edges, stream);
}

}  // namespace

// x [n_x, d] (float32, or bf16 when x_bf16), out [n_rows, d] (float32, or
// bf16 when out_bf16), the CSR (ptr [n_rows + 1] int64, col [E] int32), w
// [E] float32 or null; scale [n_x] float32 or null (each edge's weight
// divided by max(scale[col], 1)); long_rows int32, the first *n_long of
// them the rows of at least long_min edges, in any order; work: the CSR's
// work counter on the card, 0 before the launch and left 0 after it.  mean != 0 divides each row by max(count, 1).
// Returns the launch's cudaError_t.
extern "C" int gather_scatter(const void* x, int x_bf16, void* out,
                              int out_bf16, const long long* ptr,
                              const int* col, const float* w,
                              const float* scale, const int* long_rows,
                              const int* n_long, int long_min, void* work,
                              int n_rows, long long n_edges, int d, int mean,
                              void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  Args a{};
  a.x = x;
  a.out = out;
  a.ptr = ptr;
  a.col = col;
  a.w = w;
  a.scale = scale;
  a.long_rows = long_rows;
  a.n_long = n_long;
  a.work = static_cast<unsigned long long*>(work);
  a.n_rows = n_rows;
  a.d = d;
  a.mean = mean;
  a.long_min = long_min;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, n_edges, s)
                    : launch<__nv_bfloat16, float>(a, n_edges, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(a, n_edges, s)
                  : launch<float, float>(a, n_edges, s);
}
