// One hop of the quantized ring all-reduce (K3): dequantize the chunk
// that arrived, add this rank's partial, requantize against the sum's
// own abs-max scale.
//
// Replaces: autodist_tpu/kernel/pallas/quant_ring.py, _dq_add_q_kernel.
// The Pallas kernel holds the whole [1, C] chunk in VMEM and reads it
// twice there: once for max|acc|, once to write the levels.  Here the
// chunk is spread over the SMs, and the scale needs the maximum over
// every block before any level can be written, so the hop is two
// passes (the kernel boundary is the grid-wide barrier):
//
//   1. every block recomputes acc = f32(q_in) * scale_in + local over a
//      grid-stride range and folds max|acc| into one 32-bit word with
//      atomicMax on the float's bit pattern (for non-negative floats
//      the unsigned order is the float order, and a NaN's pattern is
//      above +inf's, so a NaN propagates as jnp.max propagates it);
//   2. every block derives scale = max(amax / 127, 1e-20), recomputes
//      acc and writes clip(rint(acc / scale), -127, 127) as int8; block
//      0 writes the scale.
//
// The arithmetic is the plain version's, rounding for rounding: the
// product and the sum are separately rounded (__fmul_rn, __fadd_rn: no
// contraction into an FMA), the divisions are IEEE (__fdiv_rn), and
// rintf rounds half to even.  max|acc| is order-free, so the result
// equals the plain version bit for bit, levels and scale.
//
// Bound on this card: bytes.  A hop must read q_in (1 byte) and local
// (4 bytes) and write q_out (1 byte) per element: 6 bytes, about 3.8 us
// at C = 2^21 on 3.35 TB/s.  The second pass reads q_in and local
// again; at the main path's C (10.5 MB of inputs) they are still in the
// 50 MB L2.  scale_in is read on the device and scale_out written
// there: the ring never waits on the host between hops.
#include <cuda_runtime.h>

#include <cstdint>

namespace adt {
namespace {

constexpr int kThreads = 256;
constexpr float kScaleFloor = 1e-20f;

__device__ __forceinline__ float hop_acc(const int8_t* q_in, float s_in,
                                         const float* local, long long i) {
  return __fadd_rn(__fmul_rn(static_cast<float>(q_in[i]), s_in), local[i]);
}

__global__ void __launch_bounds__(kThreads)
    amax_kernel(const int8_t* __restrict__ q_in, const float* __restrict__ scale_in,
                const float* __restrict__ local, unsigned* __restrict__ amax, long long n) {
  const float s_in = *scale_in;
  unsigned m = 0;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    m = max(m, __float_as_uint(fabsf(hop_acc(q_in, s_in, local, i))));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (threadIdx.x == 0) atomicMax(amax, m);
  }
}

__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const int8_t* __restrict__ q_in, const float* __restrict__ scale_in,
                    const float* __restrict__ local, const unsigned* __restrict__ amax,
                    int8_t* __restrict__ q_out, float* __restrict__ scale_out, long long n) {
  const float s_in = *scale_in;
  const float raw = __fdiv_rn(__uint_as_float(*amax), 127.0f);
  // max(raw, floor) that keeps a NaN, as jnp.maximum does.
  const float scale = (raw >= kScaleFloor || raw != raw) ? raw : kScaleFloor;
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const float v = rintf(__fdiv_rn(hop_acc(q_in, s_in, local, i), scale));
    q_out[i] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
}

}  // namespace
}  // namespace adt

// q_in int8 [n], scale_in fp32 [1], local fp32 [n] -> q_out int8 [n],
// scale_out fp32 [1]; amax is one 32-bit word of scratch.  Returns a
// cudaError_t (0 on success).
extern "C" int adt_quant_ring_hop(const void* q_in, const void* scale_in, const void* local,
                                  void* q_out, void* scale_out, void* amax, long long n,
                                  void* stream) {
  using namespace adt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
  amax_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const int8_t*>(q_in),
                                          static_cast<const float*>(scale_in),
                                          static_cast<const float*>(local),
                                          static_cast<unsigned*>(amax), n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int8_t*>(q_in), static_cast<const float*>(scale_in),
      static_cast<const float*>(local), static_cast<const unsigned*>(amax),
      static_cast<int8_t*>(q_out), static_cast<float*>(scale_out), n);
  return static_cast<int>(cudaGetLastError());
}
