// One hop of the quantized all-to-all ring (K8): dequantize the chunk that
// arrived, and quantize the next outgoing chunk against its own abs-max
// scale.
//
// Replaces: autodist_tpu/kernel/pallas/a2a_ring.py, _dq_and_q_kernel.
// The Pallas kernel holds the whole [1, L] chunk in VMEM and reads the
// next chunk twice there: once for max|nxt|, once to write its levels.
// Here the chunk is spread over the SMs, and the scale needs the maximum
// over every block before any level can be written.  The hop is one
// cooperative launch, as K3's (quantize_common.cuh, launch_hop):
//
//   1. each thread takes its unit of 16 elements as four quads of 4
//      (quant::Layout): each quad's levels of q_in as one 4-byte word,
//      its floats of nxt and of arrived as one float4, so that each warp
//      instruction moves one contiguous span; it writes arrived =
//      f32(q_in) * scale_in (one rounding; exact zeros where scale_in is
//      0, the ring's warm-up) and keeps nxt in registers;
//   2. the grid folds max|nxt| (warp, block, a word a block) and waits
//      at one grid-wide barrier; every block then folds the blocks'
//      words into scale = max(amax / 127, 1e-20);
//   3. each thread writes clip(rint(nxt / scale), -127, 127) from its
//      registers, a 4-byte word a quad; block 0 writes the scale.  An
//      all-zero nxt (the ring's last hop) gives exact-zero levels
//      through the floor.
//
// Quads and not K3's runs of 16 consecutive elements: with 16 floats a
// lane, each store instruction of arrived writes half sectors 64 bytes
// apart, and the hop measured 0.0184 ms against 0.0154 in quads
// on an H100 (PERF.md §6).
//
// A grid holds resident-blocks x 1024 x 16 elements in registers: 2^21
// (the main path's L) on 128 blocks, in one tile (kTiled false).  A
// larger chunk is walked in tiles of that size twice (kTiled true),
// arrived and the max first, then the levels, each tile's nxt read again
// (from the 50 MB L2 where it fits).  The vector path needs
// q_in, nxt, arrived and q_out 16-byte aligned (the ring's wire puts the
// levels 16 bytes past its start, and arrived may be a row of the ring's
// output; the wrapper checks and takes the element-wise path otherwise).
//
// The abs-max, scale and level code is quantize_common.cuh's, shared
// with K3, so the two rings round alike; with __fmul_rn, __fdiv_rn and
// rintf the result equals the plain version bit for bit: arrived, levels
// and scale.
//
// Bound on this card: bytes.  A hop must read q_in (1 byte) and nxt (4
// bytes) and write arrived (4 bytes) and q_out (1 byte) per element: 10
// bytes, about 6.3 us at L = 2^21 on 3.35 TB/s, and at the main path's L
// this kernel moves exactly those bytes, once.  scale_in is read on the
// device and scale_out written there: the ring never waits on the host
// between hops.
#include "quantize_common.cuh"

namespace adt {
namespace {

using quant::kThreads;
using quant::kUnit;

// arrived = f32(q_in) * scale_in for the unit at `base`; its nxt into v.
template <bool kVec>
__device__ __forceinline__ void hop_unit(const int8_t* __restrict__ q_in, float s_in,
                                         const float* __restrict__ nxt, float* __restrict__ arrived,
                                         long long base, long long n, float (&v)[kUnit]) {
  float q[kUnit];
  quant::load_levels<kVec, true>(q_in, base, n, q);
#pragma unroll
  for (int k = 0; k < kUnit; ++k) q[k] = __fmul_rn(q[k], s_in);
  quant::store_floats<kVec, true>(arrived, base, n, q);
  quant::load_floats<kVec, true>(nxt, base, n, v);
}

template <bool kVec, bool kTiled>
__global__ void __launch_bounds__(kThreads)
    a2a_ring_hop_kernel(const int8_t* __restrict__ q_in, const float* __restrict__ scale_in,
                        const float* __restrict__ nxt, float* __restrict__ arrived,
                        int8_t* __restrict__ q_out, float* __restrict__ scale_out,
                        unsigned* __restrict__ block_max, long long n) {
  const float s_in = *scale_in;
  const long long first = quant::unit_base<true>();
  float v[kUnit];
  if constexpr (!kTiled) {  // one tile: nxt stays in registers across the barrier
    hop_unit<kVec>(q_in, s_in, nxt, arrived, first, n, v);
    const float scale = quant::grid_scale(quant::fold_unit<true>(0u, v, first, n), block_max);
    if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
    quant::store_levels<kVec, true>(q_out, first, n, v, scale);
  } else {  // tiles: the max over every tile first, then the levels
    const long long tile = quant::tile_elems(gridDim.x);
    unsigned m = 0;
    for (long long at = first; at < n; at += tile) {
      hop_unit<kVec>(q_in, s_in, nxt, arrived, at, n, v);
      m = quant::fold_unit<true>(m, v, at, n);
    }
    const float scale = quant::grid_scale(m, block_max);
    if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
    for (long long at = first; at < n; at += tile) {
      quant::load_floats<kVec, true>(nxt, at, n, v);
      quant::store_levels<kVec, true>(q_out, at, n, v, scale);
    }
  }
}

}  // namespace
}  // namespace adt

// q_in int8 [n], scale_in fp32 [1], nxt fp32 [n] -> arrived fp32 [n],
// q_out int8 [n], scale_out fp32 [1]; block_max is `scratch_words`
// 32-bit words of scratch (one a block).  vec != 0: q_in, nxt, arrived
// and q_out are 16-byte aligned.  Returns a cudaError_t (0 on success).
extern "C" int adt_a2a_ring_hop(const void* q_in, const void* scale_in, const void* nxt,
                                void* arrived, void* q_out, void* scale_out, void* block_max,
                                long long scratch_words, long long n, int vec, void* stream) {
  using namespace adt;
  void* args[] = {&q_in, &scale_in, &nxt, &arrived, &q_out, &scale_out, &block_max, &n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? quant::launch_hop(a2a_ring_hop_kernel<true, false>,
                                 a2a_ring_hop_kernel<true, true>, args, n, scratch_words, s)
             : quant::launch_hop(a2a_ring_hop_kernel<false, false>,
                                 a2a_ring_hop_kernel<false, true>, args, n, scratch_words, s);
}
