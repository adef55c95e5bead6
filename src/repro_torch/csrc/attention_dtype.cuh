// Loads and stores of the attention kernels' two input types: float32 and
// bfloat16 tensors, with all arithmetic in float32.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pandadb {

// masked score: finite, so a fully masked row keeps a finite max
constexpr float ATTN_NEG = -1.0e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the dtype codes the wrappers pass
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

}  // namespace pandadb
