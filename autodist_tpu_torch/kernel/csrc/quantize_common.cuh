// Symmetric int8 quantization on the device, shared by the hop kernels of
// the two quantized rings (quant_ring.cu, K3; a2a_ring.cu, K8), so that
// both round alike and alike with kernel/quantize.py:
//
//   scale = max(max|x| / 127, 1e-20)      (a NaN in x gives a NaN scale)
//   level = clip(rint(x / scale), -127, 127) as int8
//
// A hop is one cooperative launch (launch_hop below): every block of the
// grid is resident at once, so the kernel can wait at a grid-wide barrier
// with its values still in registers.  A thread holds one unit of kUnit
// = 16 elements a tile (Layout: 16 consecutive elements, or four quads
// of 4 that make each warp instruction one contiguous span), moved as
// float4 and 4- or 16-byte words of levels when the arrays are 16-byte
// aligned (the vector path), or element by element otherwise.  Where one
// tile (a unit for every resident thread) holds the chunk, the kernel is
// straight-line code (kTiled false): one kernel looping over tiles took
// 0.0146 ms a hop at one tile against 0.0138 on an H100 (PERF.md §6).
// The scale needs max|x| over the whole grid: each block folds its
// threads' maxima (warp, then block) into its own word of a scratch
// array, and after one cg::this_grid().sync() every block folds all the
// words itself.  No atomics, no memset: each word is written before the
// barrier and read after it, in the same launch, and the barrier's own
// state is the launch's.
//
// The abs-max folds the float's bit pattern: for non-negative floats the
// unsigned order is the float order, and a NaN's pattern is above +inf's,
// so a NaN propagates as jnp.max propagates it.  Divisions are IEEE
// (__fdiv_rn), rintf rounds half to even, and a NaN quotient gives level
// 0, as PyTorch's float-to-int8 conversion does.  A max is order-free,
// so the result equals the plain version bit for bit.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace adt {
namespace quant {

constexpr int kThreads = 1024;
constexpr int kUnit = 16;
constexpr float kScaleFloor = 1e-20f;

// |v| as bits whose unsigned order is the order of |v|.
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }

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

// A thread's unit is kUnit elements of a tile, in one of two layouts:
//   run  (kQuad false): 16 consecutive elements, thread t's at t * 16;
//        its levels move as one int4, its floats as four float4;
//   quad (kQuad true): four quads of 4 consecutive elements, lane l of a
//        warp at l * 4 + j * 128 within the warp's 512 elements; a quad's
//        levels move as one 4-byte word and its floats as one float4, so
//        each warp instruction covers one contiguous span.
// Every layout splits the unit into kSegs segments of kSeg consecutive
// elements, segment j at base + j * kStride.
template <bool kQuad>
struct Layout {
  static constexpr int kSegs = kQuad ? 4 : 1;
  static constexpr int kSeg = kUnit / kSegs;
  static constexpr long long kStride = kQuad ? 32 * 4 : kUnit;
  using Levels = typename std::conditional<kQuad, unsigned, int4>::type;
};

// The first element of this thread's unit within a tile.
template <bool kQuad>
__device__ __forceinline__ long long unit_base() {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  return kQuad ? (t >> 5) * 32 * kUnit + (t & 31) * 4 : t * kUnit;
}

// The elements of the segment at `at` that lie below n (0 to len).
__device__ __forceinline__ int valid_in(long long at, long long n, int len) {
  const long long left = n - at;
  return left <= 0 ? 0 : (left < len ? static_cast<int>(left) : len);
}

// Byte i of a little-endian word, sign-extended.
__device__ __forceinline__ float level_byte(unsigned w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

// Word k of a segment's levels, and the levels of a segment's words.
__device__ __forceinline__ unsigned word_of(unsigned w, int) { return w; }
__device__ __forceinline__ unsigned word_of(const int4& w, int k) {
  return static_cast<unsigned>(k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w);
}
__device__ __forceinline__ unsigned levels_of(const unsigned (&w)[1]) { return w[0]; }
__device__ __forceinline__ int4 levels_of(const unsigned (&w)[4]) {
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]), static_cast<int>(w[2]),
                   static_cast<int>(w[3]));
}

// The unit's levels as floats; 0 past n.
template <bool kVec, bool kQuad>
__device__ __forceinline__ void load_levels(const int8_t* __restrict__ q, long long base,
                                            long long n, float (&v)[kUnit]) {
  using L = Layout<kQuad>;
#pragma unroll
  for (int j = 0; j < L::kSegs; ++j) {
    const long long at = base + j * L::kStride;
    const int valid = valid_in(at, n, L::kSeg);
    float* out = v + j * L::kSeg;
    if (kVec && valid == L::kSeg) {
      const typename L::Levels w = *reinterpret_cast<const typename L::Levels*>(q + at);
#pragma unroll
      for (int k = 0; k < L::kSeg; ++k) out[k] = level_byte(word_of(w, k / 4), k % 4);
    } else {
#pragma unroll
      for (int k = 0; k < L::kSeg; ++k) out[k] = k < valid ? static_cast<float>(q[at + k]) : 0.0f;
    }
  }
}

// The unit's floats; 0 past n.
template <bool kVec, bool kQuad>
__device__ __forceinline__ void load_floats(const float* __restrict__ x, long long base,
                                            long long n, float (&v)[kUnit]) {
  using L = Layout<kQuad>;
#pragma unroll
  for (int j = 0; j < L::kSegs; ++j) {
    const long long at = base + j * L::kStride;
    const int valid = valid_in(at, n, L::kSeg);
    float* out = v + j * L::kSeg;
    if (kVec && valid == L::kSeg) {
#pragma unroll
      for (int k = 0; k < L::kSeg; k += 4) {
        const float4 f = *reinterpret_cast<const float4*>(x + at + k);
        out[k] = f.x, out[k + 1] = f.y, out[k + 2] = f.z, out[k + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < L::kSeg; ++k) out[k] = k < valid ? x[at + k] : 0.0f;
    }
  }
}

// Write the unit's floats below n.
template <bool kVec, bool kQuad>
__device__ __forceinline__ void store_floats(float* __restrict__ x, long long base, long long n,
                                             const float (&v)[kUnit]) {
  using L = Layout<kQuad>;
#pragma unroll
  for (int j = 0; j < L::kSegs; ++j) {
    const long long at = base + j * L::kStride;
    const int valid = valid_in(at, n, L::kSeg);
    const float* in = v + j * L::kSeg;
    if (kVec && valid == L::kSeg) {
#pragma unroll
      for (int k = 0; k < L::kSeg; k += 4)
        *reinterpret_cast<float4*>(x + at + k) = make_float4(in[k], in[k + 1], in[k + 2], in[k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < L::kSeg; ++k)
        if (k < valid) x[at + k] = in[k];
    }
  }
}

// Write level(v, scale) for the unit's elements below n.
template <bool kVec, bool kQuad>
__device__ __forceinline__ void store_levels(int8_t* __restrict__ q, long long base, long long n,
                                             const float (&v)[kUnit], float scale) {
  using L = Layout<kQuad>;
#pragma unroll
  for (int j = 0; j < L::kSegs; ++j) {
    const long long at = base + j * L::kStride;
    const int valid = valid_in(at, n, L::kSeg);
    const float* in = v + j * L::kSeg;
    if (kVec && valid == L::kSeg) {
      unsigned words[L::kSeg / 4];
#pragma unroll
      for (int k = 0; k < L::kSeg; k += 4) {
        words[k / 4] = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          words[k / 4] |= static_cast<unsigned>(static_cast<uint8_t>(level(in[k + i], scale)))
                          << (8 * i);
      }
      *reinterpret_cast<typename L::Levels*>(q + at) = levels_of(words);
    } else {
#pragma unroll
      for (int k = 0; k < L::kSeg; ++k)
        if (k < valid) q[at + k] = level(in[k], scale);
    }
  }
}

// max |v| over the unit's elements below n, folded into m.
template <bool kQuad>
__device__ __forceinline__ unsigned fold_unit(unsigned m, const float (&v)[kUnit], long long base,
                                              long long n) {
  using L = Layout<kQuad>;
#pragma unroll
  for (int j = 0; j < L::kSegs; ++j) {
    const int valid = valid_in(base + j * L::kStride, n, L::kSeg);
#pragma unroll
    for (int k = 0; k < L::kSeg; ++k)
      if (k < valid) m = max(m, abs_bits(v[j * L::kSeg + k]));
  }
  return m;
}

// The scale of max|x| over the whole grid, given each thread's m: the
// block's maximum goes to its word of block_max, every block waits at the
// grid barrier, then folds every block's word.  Every thread of every
// block must call it, once a launch.
__device__ __forceinline__ float grid_scale(unsigned m, unsigned* __restrict__ block_max) {
  __shared__ unsigned warp_max[kThreads / 32];
  __shared__ float scale;
  static_assert(kThreads / 32 == 32, "one warp folds the warps' maxima");
  const int lane = threadIdx.x & 31;
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = __reduce_max_sync(0xffffffffu, warp_max[lane]);
    if (lane == 0) block_max[blockIdx.x] = m;
  }
  cooperative_groups::this_grid().sync();
  if (threadIdx.x < 32) {
    unsigned g = 0;
    for (unsigned b = lane; b < gridDim.x; b += 32) g = max(g, __ldcg(block_max + b));
    g = __reduce_max_sync(0xffffffffu, g);
    if (lane == 0) scale = scale_of(g);
  }
  __syncthreads();
  return scale;
}

// The elements of one tile (a unit for every thread) on `blocks` blocks.
__host__ __device__ __forceinline__ long long tile_elems(unsigned blocks) {
  return static_cast<long long>(blocks) * kThreads * kUnit;
}

// Blocks of `kernel` (kThreads each) that the card keeps resident at
// once: occupancy x SMs.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  *blocks = static_cast<long long>(per_sm) * sms;
  return err;
}

// Launch a hop cooperatively over n elements: `one_tile` where the
// resident blocks hold every element in one tile (as many blocks as
// that takes), else `tiled` on every resident block; at most
// `scratch_words` blocks (block_max's length).  Returns a cudaError_t
// (0 on success); a launch the CUDA runtime refuses returns its error and
// never runs.
template <typename Kernel>
int launch_hop(Kernel one_tile, Kernel tiled, void** args, long long n, long long scratch_words,
               cudaStream_t stream) {
  long long resident = 0;
  Kernel kernel = one_tile;
  const long long want = (n + tile_elems(1) - 1) / tile_elems(1);
  cudaError_t err = resident_blocks(one_tile, &resident);
  if (err == cudaSuccess && want > resident) {
    kernel = tiled;
    err = resident_blocks(tiled, &resident);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused call leaves no error behind for later launches
    return static_cast<int>(err);
  }
  long long blocks = want < resident ? want : resident;
  if (blocks < 1) blocks = 1;
  if (blocks > scratch_words) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0,
                                    stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace quant
}  // namespace adt
