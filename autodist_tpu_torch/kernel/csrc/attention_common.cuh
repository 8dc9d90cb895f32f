// Helpers shared by the attention kernels: element conversions, warp
// reductions and the dispatch over element type and head dim.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace adt {

// float32 finfo.min: the finite mask value of the JAX package.  With
// -inf, a fully masked tile would give inf - inf = NaN.
constexpr float kNegInf = -3.4028234663852886e38f;
constexpr unsigned kFullMask = 0xffffffffu;

// dtype codes shared with the Python wrappers.
enum DType : int { kF32 = 0, kBF16 = 1 };

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Calls fn.template operator()<T, D>() for the runtime (dtype, head dim):
// fp32 and bf16 at head dim 64, the pairs a ported configuration runs.
// Returns -1 for any other pair.
template <typename Fn>
int dispatch(int dtype, int head_dim, Fn fn) {
  if (head_dim != 64) return -1;
  switch (dtype) {
    case kF32: return fn.template operator()<float, 64>();
    case kBF16: return fn.template operator()<__nv_bfloat16, 64>();
    default: return -1;
  }
}

}  // namespace adt
