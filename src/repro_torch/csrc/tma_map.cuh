// TMA tensor maps of the attention kernels' [n_b, seq, heads, d] tensors:
// their bf16 inputs (flash_attention.cu, flash_attention_bwd.cu) and the
// backward's float32 dq sums.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pandadb {

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so
// the library links no libcuda of its own
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a [n_b, seq, heads, d] tensor of `type` (elements of `size`
// bytes) read or written in boxes of `rows` positions of one head, in
// chunks of w columns: dimensions (w, seq, d / w, heads, n_b), swizzled over
// the chunk's w size bytes (32, 64 or 128), so a box lands chunk after
// chunk, each chunk row-major and swizzled as wgmma reads it (hopper.cuh).
// Positions past seq read as zeros and are not written.  A map the driver
// refuses returns 10000 + its CUresult.
inline int make_map_of(CUtensorMap* map, CUtensorMapDataType type,
                       cuuint64_t size, const void* base, int n_b, int seq,
                       int heads, int d, int w, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[5] = {(cuuint64_t)w, (cuuint64_t)seq,
                              (cuuint64_t)(d / w), (cuuint64_t)heads,
                              (cuuint64_t)n_b};
  const cuuint64_t strides[4] = {(cuuint64_t)heads * d * size, w * size,
                                 (cuuint64_t)d * size,
                                 (cuuint64_t)seq * heads * d * size};
  const cuuint32_t box[5] = {(cuuint32_t)w, (cuuint32_t)rows,
                             (cuuint32_t)(d / w), 1, 1};
  const cuuint64_t span = w * size;
  const CUtensorMapSwizzle swizzle = span == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, type, 5, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

// a bf16 tensor's map, chunks of w columns (2 w bytes)
inline int make_map(CUtensorMap* map, const __nv_bfloat16* base, int n_b,
                    int seq, int heads, int d, int w, int rows) {
  return make_map_of(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, n_b, seq,
                     heads, d, w, rows);
}

// The column chunk of a width: 64 bf16 (128-byte rows) where 64 divides it,
// else 32 or 16.
__host__ __device__ constexpr int chunk_of(int d) {
  return d % 64 == 0 ? 64 : d % 32 == 0 ? 32 : 16;
}

}  // namespace pandadb
