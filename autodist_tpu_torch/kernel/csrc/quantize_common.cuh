// Symmetric int8 quantization on the device, shared by the hop kernels of
// the two quantized rings (quant_ring.cu, K3; a2a_ring.cu, K8), so that
// both round alike and alike with kernel/quantize.py:
//
//   scale = max(max|x| / 127, 1e-20)      (a NaN in x gives a NaN scale)
//   level = clip(rint(x / scale), -127, 127) as int8
//
// The abs-max spans every block of a hop, so it is folded into one
// 32-bit word with atomicMax on the float's bit pattern: for
// non-negative floats the unsigned order is the float order, and a
// NaN's pattern is above +inf's, so a NaN propagates as jnp.max
// propagates it.  Divisions are IEEE (__fdiv_rn), rintf rounds half to
// even, and a NaN quotient gives level 0, as PyTorch's float-to-int8
// conversion does.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace adt {
namespace quant {

constexpr int kThreads = 256;
constexpr float kScaleFloor = 1e-20f;

// |v| as bits whose unsigned order is the order of |v|.
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }

// Fold every thread's m into *amax: a warp max, a block max, one
// atomicMax per block.  Every thread of the block must call it.
__device__ __forceinline__ void block_fold_max(unsigned m, unsigned* amax) {
  __shared__ unsigned warp_max[kThreads / 32];
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (threadIdx.x == 0) atomicMax(amax, m);
  }
}

// max(amax / 127, 1e-20) that keeps a NaN, as jnp.maximum does.
__device__ __forceinline__ float scale_of(unsigned amax_bits) {
  const float raw = __fdiv_rn(__uint_as_float(amax_bits), 127.0f);
  return (raw >= kScaleFloor || raw != raw) ? raw : kScaleFloor;
}

// clip(rint(v / scale), -127, 127) as int8; a NaN gives 0.
__device__ __forceinline__ int8_t level(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  if (r != r) return 0;
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// Blocks for a grid-stride pass over n elements: one thread an element,
// at most 8 blocks an SM.
inline int grid_blocks(long long n) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + kThreads - 1) / kThreads;
  return static_cast<int>(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
}

}  // namespace quant
}  // namespace adt
