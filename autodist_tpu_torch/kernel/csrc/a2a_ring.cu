// One hop of the quantized all-to-all ring (K8): dequantize the chunk that
// arrived, and quantize the next outgoing chunk against its own abs-max
// scale.
//
// Replaces: autodist_tpu/kernel/pallas/a2a_ring.py, _dq_and_q_kernel.
// The Pallas kernel holds the whole [1, L] chunk in VMEM and reads the
// next chunk twice there: once for max|nxt|, once to write its levels.
// Here the chunk is spread over the SMs, and the scale needs the maximum
// over every block before any level can be written, so the hop is two
// passes, as K3's (the kernel boundary is the grid-wide barrier):
//
//   1. every block writes arrived = f32(q_in) * scale_in (one rounding;
//      exact zeros where scale_in is 0, the ring's warm-up) over a
//      grid-stride range and folds max|nxt| into one 32-bit word with
//      atomicMax on the float's bit pattern;
//   2. every block derives scale = max(amax / 127, 1e-20) and writes
//      clip(rint(nxt / scale), -127, 127) as int8; block 0 writes the
//      scale.  An all-zero nxt (the ring's last hop) gives exact-zero
//      levels through the floor.
//
// The abs-max, scale and level code is quantize_common.cuh's, shared
// with K3, so the two rings round alike; with __fmul_rn, __fdiv_rn and
// rintf the result equals the plain version bit for bit: arrived, levels
// and scale.
//
// Bound on this card: bytes.  A hop must read q_in (1 byte) and nxt (4
// bytes) and write arrived (4 bytes) and q_out (1 byte) per element: 10
// bytes, about 6.3 us at L = 2^21 on 3.35 TB/s.  The second pass reads
// nxt again; at the main path's L (8 MB) it is still in the 50 MB L2.
// scale_in is read on the device and scale_out written there: the ring
// never waits on the host between hops.
#include "quantize_common.cuh"

namespace adt {
namespace {

using quant::kThreads;

__global__ void __launch_bounds__(kThreads)
    dequantize_amax_kernel(const int8_t* __restrict__ q_in, const float* __restrict__ scale_in,
                           const float* __restrict__ nxt, float* __restrict__ arrived,
                           unsigned* __restrict__ amax, long long n) {
  const float s_in = *scale_in;
  unsigned m = 0;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    arrived[i] = __fmul_rn(static_cast<float>(q_in[i]), s_in);
    m = max(m, quant::abs_bits(nxt[i]));
  }
  quant::block_fold_max(m, amax);
}

__global__ void __launch_bounds__(kThreads)
    quantize_next_kernel(const float* __restrict__ nxt, const unsigned* __restrict__ amax,
                         int8_t* __restrict__ q_out, float* __restrict__ scale_out, long long n) {
  const float scale = quant::scale_of(*amax);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    q_out[i] = quant::level(nxt[i], scale);
  }
}

}  // namespace
}  // namespace adt

// q_in int8 [n], scale_in fp32 [1], nxt fp32 [n] -> arrived fp32 [n],
// q_out int8 [n], scale_out fp32 [1]; amax is one 32-bit word of
// scratch.  Returns a cudaError_t (0 on success).
extern "C" int adt_a2a_ring_hop(const void* q_in, const void* scale_in, const void* nxt,
                                void* arrived, void* q_out, void* scale_out, void* amax,
                                long long n, void* stream) {
  using namespace adt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = quant::grid_blocks(n);
  dequantize_amax_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int8_t*>(q_in), static_cast<const float*>(scale_in),
      static_cast<const float*>(nxt), static_cast<float*>(arrived),
      static_cast<unsigned*>(amax), n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_next_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(nxt), static_cast<const unsigned*>(amax),
      static_cast<int8_t*>(q_out), static_cast<float*>(scale_out), n);
  return static_cast<int>(cudaGetLastError());
}
