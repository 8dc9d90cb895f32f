// One hop of the quantized ring all-reduce (K3): dequantize the chunk
// that arrived, add this rank's partial, requantize against the sum's
// own abs-max scale.
//
// Replaces: autodist_tpu/kernel/pallas/quant_ring.py, _dq_add_q_kernel.
// The Pallas kernel holds the whole [1, C] chunk in VMEM and reads it
// twice there: once for max|acc|, once to write the levels.  Here the
// chunk is spread over the SMs, and the scale needs the maximum over
// every block before any level can be written.  The hop is one
// cooperative launch (quantize_common.cuh, launch_hop):
//
//   1. each thread loads its unit of 16 consecutive elements
//      (quant::Layout's runs), their 16 levels of q_in as one int4 and
//      their floats of local as four float4, and keeps acc = f32(q_in) *
//      scale_in + local in registers (runs and not K8's quads: 0.0138
//      against 0.0147 ms a hop on an H100, PERF.md §6);
//   2. the grid folds max|acc| (warp, block, a word a block) and waits
//      at one grid-wide barrier; every block then folds the blocks'
//      words into scale = max(amax / 127, 1e-20);
//   3. each thread writes clip(rint(acc / scale), -127, 127) from its
//      registers as one int4; block 0 writes the scale.
//
// A grid holds resident-blocks x 1024 x 16 elements in registers: 2^21
// (the main path's C) on 128 blocks, in one tile (kTiled false).  A
// larger chunk is walked in tiles of that size twice (kTiled true), the
// max first, then the levels, each tile read again (from the 50 MB L2
// where it fits).  The vector path needs q_in, local and q_out
// 16-byte aligned (the ring's wire puts the levels 16 bytes past its
// start; the wrapper checks and takes the element-wise path otherwise).
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
// at C = 2^21 on 3.35 TB/s, and at the main path's C this kernel moves
// exactly those bytes, once.  scale_in is read on the device and
// scale_out written there: the ring never waits on the host between hops.
#include "quantize_common.cuh"

namespace adt {
namespace {

using quant::kThreads;
using quant::kUnit;

template <bool kVec>
__device__ __forceinline__ void hop_unit(const int8_t* __restrict__ q_in, float s_in,
                                         const float* __restrict__ local, long long base,
                                         long long n, float (&acc)[kUnit]) {
  float q[kUnit];
  quant::load_levels<kVec, false>(q_in, base, n, q);
  quant::load_floats<kVec, false>(local, base, n, acc);
#pragma unroll
  for (int k = 0; k < kUnit; ++k) acc[k] = __fadd_rn(__fmul_rn(q[k], s_in), acc[k]);
}

template <bool kVec, bool kTiled>
__global__ void __launch_bounds__(kThreads)
    quant_ring_hop_kernel(const int8_t* __restrict__ q_in, const float* __restrict__ scale_in,
                          const float* __restrict__ local, int8_t* __restrict__ q_out,
                          float* __restrict__ scale_out, unsigned* __restrict__ block_max,
                          long long n) {
  const float s_in = *scale_in;
  const long long first = quant::unit_base<false>();
  float acc[kUnit];
  if constexpr (!kTiled) {  // one tile: acc stays in registers across the barrier
    hop_unit<kVec>(q_in, s_in, local, first, n, acc);
    const float scale = quant::grid_scale(quant::fold_unit<false>(0u, acc, first, n), block_max);
    if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
    quant::store_levels<kVec, false>(q_out, first, n, acc, scale);
  } else {  // tiles: the max over every tile first, then the levels
    const long long tile = quant::tile_elems(gridDim.x);
    unsigned m = 0;
    for (long long at = first; at < n; at += tile) {
      hop_unit<kVec>(q_in, s_in, local, at, n, acc);
      m = quant::fold_unit<false>(m, acc, at, n);
    }
    const float scale = quant::grid_scale(m, block_max);
    if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
    for (long long at = first; at < n; at += tile) {
      hop_unit<kVec>(q_in, s_in, local, at, n, acc);
      quant::store_levels<kVec, false>(q_out, at, n, acc, scale);
    }
  }
}

}  // namespace
}  // namespace adt

// q_in int8 [n], scale_in fp32 [1], local fp32 [n] -> q_out int8 [n],
// scale_out fp32 [1]; block_max is `scratch_words` 32-bit words of
// scratch (one a block).  vec != 0: q_in, local and q_out are 16-byte
// aligned.  Returns a cudaError_t (0 on success).
extern "C" int adt_quant_ring_hop(const void* q_in, const void* scale_in, const void* local,
                                  void* q_out, void* scale_out, void* block_max,
                                  long long scratch_words, long long n, int vec, void* stream) {
  using namespace adt;
  void* args[] = {&q_in, &scale_in, &local, &q_out, &scale_out, &block_max, &n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? quant::launch_hop(quant_ring_hop_kernel<true, false>,
                                 quant_ring_hop_kernel<true, true>, args, n, scratch_words, s)
             : quant::launch_hop(quant_ring_hop_kernel<false, false>,
                                 quant_ring_hop_kernel<false, true>, args, n, scratch_words, s);
}
