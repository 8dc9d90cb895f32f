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
// contraction into an FMA); the abs-max, the scale and the levels are
// quantize_common.cuh's, shared with K8 (__fdiv_rn, rintf).  max|acc| is
// order-free, so the result equals the plain version bit for bit, levels
// and scale.
//
// Bound on this card: bytes.  A hop must read q_in (1 byte) and local
// (4 bytes) and write q_out (1 byte) per element: 6 bytes, about 3.8 us
// at C = 2^21 on 3.35 TB/s.  The second pass reads q_in and local
// again; at the main path's C (10.5 MB of inputs) they are still in the
// 50 MB L2.  scale_in is read on the device and scale_out written
// there: the ring never waits on the host between hops.
#include "quantize_common.cuh"

namespace adt {
namespace {

using quant::kThreads;

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
    m = max(m, quant::abs_bits(hop_acc(q_in, s_in, local, i)));
  }
  quant::block_fold_max(m, amax);
}

__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const int8_t* __restrict__ q_in, const float* __restrict__ scale_in,
                    const float* __restrict__ local, const unsigned* __restrict__ amax,
                    int8_t* __restrict__ q_out, float* __restrict__ scale_out, long long n) {
  const float s_in = *scale_in;
  const float scale = quant::scale_of(*amax);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    q_out[i] = quant::level(hop_acc(q_in, s_in, local, i), scale);
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
  const int blocks = quant::grid_blocks(n);
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
