// Flash decode for Hopper: one query per (slot, head) against a dense
// cache lane or a paged block pool, online softmax in fp32.
//
// Replaces: autodist_tpu/kernel/pallas/flash_decode.py, _decode_kernel
// (dense, K5) and _paged_decode_kernel (paged, K6).  The Pallas kernels
// run a (slot, head) grid — plus a sequential logical-block axis in the
// paged one — and carry the running max / sum / accumulator across grid
// steps in VMEM scratch, with the block table scalar-prefetched into
// SMEM.  Here one thread block per (slot, head) runs the whole key loop
// itself: it reads its slot's length and, paged, its own block-table
// entries, masks the ragged tail itself (no zero-padding of T) and stops
// after the last visible key — masked keys would contribute exactly
// exp(NEG_INF - m) = 0, so the result is the same, and their values
// (stale rows of an earlier occupant) are never read.
//
// Bound on this card: bytes.  A step reads each visible key's K and V
// row once (2 * (length + 1) * head_dim * sizeof(T) bytes per (slot,
// head)) and does 4 * head_dim flops per key, about one flop per byte
// at bf16, far below the ~295 flops per byte where the tensor cores
// would bound it.  The design therefore spends nothing on tensor cores
// and everything on keeping loads in flight: each of the block's 8
// warps takes every 8th tile of 32 keys; a lane issues its key's V row
// as cp.async copies into the warp's shared-memory tile, then scores the
// key with 16-byte vector loads of its K row against the query held in
// shared memory, so both rows' latencies overlap; the warp then
// accumulates P.V from the staged tile with each lane owning head_dim /
// 32 output dims.  The 8 warps keep independent (max, sum, acc) states
// that are merged once at the end.  Statistics and accumulator are fp32
// whatever the cache type; the output is cast to the cache type.
// wgmma, TMA and splitting one (slot, head) over several blocks are
// later work.
#include <cuda_pipeline.h>

#include "attention_common.cuh"

namespace adt {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // keys per warp step: one per lane
constexpr int kMaxDevices = 64;

struct DecodeArgs {
  const void* q;       // [B, 1, H, D]
  const void* k;       // dense [B, H, T, D]; paged [NB, H, bl, D]
  const void* v;
  const int* lengths;  // [B]: keys at positions <= lengths[b] are visible
  const int* table;    // paged: [B, mb] logical -> pool block; dense: null
  void* out;           // [B, 1, H, D]
  int heads;
  int extent;          // dense: T; paged: bl
  int max_blocks;      // paged: mb
  int num_blocks;      // paged: NB
  float scale;
};

template <typename T, int D, bool kPaged>
__device__ __forceinline__ const T* row_ptr(const T* base, const DecodeArgs& a,
                                            int b, int h, int t) {
  if (kPaged) {
    const int bl = a.extent;
    int blk = __ldg(a.table + (size_t)b * a.max_blocks + t / bl);
    blk = min(max(blk, 0), a.num_blocks - 1);  // memory safety only
    return base + (((size_t)blk * a.heads + h) * bl + t % bl) * D;
  }
  return base + (((size_t)b * a.heads + h) * a.extent + t) * D;
}

template <typename T, int D, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  constexpr int kDpl = D / 32;  // output dims per lane: lane + 32 * i
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  __shared__ float sq[D];
  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ float s_acc[kWarps][D];
  // This warp's V tile [32][D] in the cache type, filled by cp.async.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sv = reinterpret_cast<T*>(smem_raw) + (size_t)warp * kTile * D;
  constexpr int kVec = 16 / sizeof(T);

  for (int i = threadIdx.x; i < D; i += kThreads)
    sq[i] = to_float(q[((size_t)b * a.heads + h) * D + i]);
  __syncthreads();

  const int extent = kPaged ? a.max_blocks * a.extent : a.extent;
  const int n_vis = min(a.lengths[b] + 1, extent);  // keys [0, n_vis)

  float m = kNegInf, l = 0.f, acc[kDpl];
#pragma unroll
  for (int i = 0; i < kDpl; ++i) acc[i] = 0.f;

  for (int t0 = warp * kTile; t0 < n_vis; t0 += kWarps * kTile) {
    const int t = t0 + lane;
    float s = kNegInf;
    if (t < n_vis) {
      const T* vr = row_ptr<T, D, kPaged>(v, a, b, h, t);
#pragma unroll
      for (int c = 0; c < D; c += kVec) __pipeline_memcpy_async(sv + lane * D + c, vr + c, 16);
      s = dot_row<T, D>(sq, row_ptr<T, D, kPaged>(k, a, b, h, t)) * a.scale;
    }
    __pipeline_commit();
    // Key t0 is visible, so m_new is finite from the first tile on.
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = t < n_vis ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[i] *= alpha;
    __pipeline_wait_prior(0);
    __syncwarp();  // every lane's V row has landed in the tile
    const int jn = min(kTile, n_vis - t0);  // uniform across the warp
    for (int j = 0; j < jn; ++j) {
      const float pj = __shfl_sync(kFullMask, p, j);
#pragma unroll
      for (int i = 0; i < kDpl; ++i) acc[i] = fmaf(pj, to_float(sv[j * D + lane + 32 * i]), acc[i]);
    }
    __syncwarp();  // the tile is read before the next one overwrites it
    m = m_new;
  }

  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kDpl; ++i) s_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  // Merge the warps' states; a warp that saw no tile holds
  // (NEG_INF, 0, 0) and weighs exp(NEG_INF - M) = 0.
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w] - M);
      L += s_l[w] * c;
      A += s_acc[w][d] * c;
    }
    T* out = static_cast<T*>(a.out);
    out[((size_t)b * a.heads + h) * D + d] = from_float<T>(n_vis > 0 ? A / L : 0.f);
  }
}

template <bool kPaged>
struct LaunchDecode {
  DecodeArgs a;
  int batch;
  cudaStream_t stream;
  template <typename T, int D>
  int operator()() const {
    const int bytes = kWarps * kTile * D * sizeof(T);
    // The shared-memory limit is an attribute of the kernel on each
    // device: raise it once per device this instantiation runs on.
    static bool configured[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices || !configured[dev]) {
      err = cudaFuncSetAttribute(decode_kernel<T, D, kPaged>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) configured[dev] = true;
    }
    decode_kernel<T, D, kPaged><<<dim3(a.heads, batch), kThreads, bytes, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace
}  // namespace adt

// Dense flash decode (K5).  Returns 0, a cudaError_t, or -1 for an
// unsupported (dtype, head_dim).
extern "C" int adt_flash_decode_dense(const void* q, const void* k, const void* v,
                                      const int* lengths, void* out, int batch,
                                      int heads, int seq_len, int head_dim, int dtype,
                                      float scale, void* stream) {
  adt::DecodeArgs a{q, k, v, lengths, nullptr, out, heads, seq_len, 0, 0, scale};
  return adt::dispatch(dtype, head_dim,
                       adt::LaunchDecode<false>{a, batch, static_cast<cudaStream_t>(stream)});
}

// Paged flash decode (K6).
extern "C" int adt_flash_decode_paged(const void* q, const void* k_pool,
                                      const void* v_pool, const int* lengths,
                                      const int* table, void* out, int batch, int heads,
                                      int block_len, int max_blocks, int num_blocks,
                                      int head_dim, int dtype, float scale, void* stream) {
  adt::DecodeArgs a{q,     k_pool,    v_pool,     lengths,    table, out,
                    heads, block_len, max_blocks, num_blocks, scale};
  return adt::dispatch(dtype, head_dim,
                       adt::LaunchDecode<true>{a, batch, static_cast<cudaStream_t>(stream)});
}
