// Paged flash prefill for Hopper: one prompt chunk's C queries per
// (slot, head), causal over everything the block pool holds for the
// slot, online softmax in fp32.
//
// Replaces: autodist_tpu/kernel/pallas/flash_prefill.py,
// _paged_prefill_kernel (K7).  The Pallas kernel runs a (slot, head,
// logical block) grid whose index maps read the scalar-prefetched block
// table, and carries [C, 1] max / sum and a [C, d] accumulator across
// the block axis in VMEM scratch.  Here one thread block per (slot,
// head, group of 16 chunk rows) walks the logical blocks itself: it
// reads its slot's start and block-table entries, stages 32 keys of K
// and V at a time in shared memory with 16-byte vector loads (rows past
// the last key its queries see are neither read nor staged), and keeps
// the per-row carries in registers across the walk.  Chunk row r sits
// at position starts[b] + r and sees keys <= starts[b] + r; a tile
// wholly above a warp's rows is skipped, and a row's masked keys weigh
// p = 0 exactly, as exp(NEG_INF - m) = 0 does in the Pallas kernel.
//
// Bound on this card: bytes at the serving shapes.  Each visible K/V
// row is needed once per (slot, head) and reused by all C queries, so a
// chunk does about C / 2 flops per byte — well under the ~295 flops per
// byte where bf16 tensor cores would bound it.  This simple kernel
// computes its products on the fp32 CUDA cores, where instruction issue,
// not bytes, limits it; the design spends its effort there.  Splitting
// a chunk's rows over blocks of 16 spreads a long slot's key walk over
// several SMs (at the price of each block staging the keys its rows
// see: up to C / 16 reads of a K/V row, mostly from L2).  Each of the 4
// warps owns 4 consecutive rows in registers, so one 16-byte read of a
// staged key (a shared-memory row padded to keep 32 lanes on distinct
// banks) serves 4 dot products, and one read of a staged value serves 4
// accumulators; each lane owns head_dim / 32 output dims.  wgmma on the
// staged tiles is the way to the tensor cores and is later work.
#include "attention_common.cuh"

namespace adt {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // chunk rows per block
constexpr int kTile = 32;                     // keys staged per step

struct PrefillArgs {
  const void* q;      // [B, C, H, D]
  const void* k;      // [NB, H, bl, D]
  const void* v;
  const int* starts;  // [B]: position of chunk row 0
  const int* table;   // [B, mb]
  void* out;          // [B, C, H, D]
  int chunk;
  int heads;
  int block_len;
  int max_blocks;
  int num_blocks;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) prefill_kernel(PrefillArgs a) {
  constexpr int kDpl = D / 32;        // output dims per lane: lane + 32 * i
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowVecs = D / kVec;  // 16-byte vectors per cache row
  constexpr int kKStride = D + 4;     // padded: 16-byte aligned, conflict-free
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C = a.chunk, bl = a.block_len;
  const int row0 = blockIdx.z * kRows;            // this block's first row
  const int rows = min(kRows, C - row0);
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  __shared__ __align__(16) float sq[kRows * D];
  __shared__ __align__(16) float sk[kTile * kKStride];
  __shared__ __align__(16) float sv[kTile * D];

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    sq[i] = r < rows ? to_float(q[(((size_t)b * C + row0 + r) * a.heads + h) * D + d]) : 0.f;
  }
  const int start = a.starts[b];
  // Keys this block's last row sees: [0, n_keys).
  const int n_keys = min(start + row0 + rows, a.max_blocks * bl);
  const int* row_table = a.table + (size_t)b * a.max_blocks;

  // This warp's rows; a row past the chunk sees no key (qpos = -1).
  const int wrow = warp * kRowsPerWarp;
  int qpos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDpl];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    qpos[i] = wrow + i < rows ? start + row0 + wrow + i : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < kDpl; ++k) acc[i][k] = 0.f;
  }
  int warp_last = -1;  // the warp's last visible key
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) warp_last = max(warp_last, min(qpos[i], n_keys - 1));

  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    __syncthreads();  // the previous tile has been read
#pragma unroll
    for (int c = threadIdx.x; c < kTile * kRowVecs; c += kThreads) {
      const int row = c / kRowVecs, d0 = (c % kRowVecs) * kVec, t = t0 + row;
      uint4 kraw = make_uint4(0, 0, 0, 0), vraw = kraw;
      if (t < n_keys) {
        int blk = __ldg(row_table + t / bl);
        blk = min(max(blk, 0), a.num_blocks - 1);  // memory safety only
        const size_t off = (((size_t)blk * a.heads + h) * bl + t % bl) * D + d0;
        kraw = __ldg(reinterpret_cast<const uint4*>(kp + off));
        vraw = __ldg(reinterpret_cast<const uint4*>(vp + off));
      }
      const T* ke = reinterpret_cast<const T*>(&kraw);
      const T* ve = reinterpret_cast<const T*>(&vraw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        sk[row * kKStride + d0 + e] = to_float(ke[e]);
        sv[row * D + d0 + e] = to_float(ve[e]);
      }
    }
    __syncthreads();
    if (t0 > warp_last) continue;  // the tile is above all of this warp's rows

    // Scores of key t0 + lane for the warp's 4 rows.
    const int t = t0 + lane;
    float dot[kRowsPerWarp] = {};
    const float4* kr = reinterpret_cast<const float4*>(sk + lane * kKStride);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kk = kr[d4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qq = reinterpret_cast<const float4*>(sq + (wrow + i) * D)[d4];
        dot[i] = fmaf(qq.x, kk.x, dot[i]);
        dot[i] = fmaf(qq.y, kk.y, dot[i]);
        dot[i] = fmaf(qq.z, kk.z, dot[i]);
        dot[i] = fmaf(qq.w, kk.w, dot[i]);
      }
    }
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const bool vis = t <= qpos[i] && t < n_keys;
      const float s = vis ? dot[i] * a.scale : kNegInf;
      // A row whose keys all lie below t0 keeps m: alpha = 1, p = 0.
      const float m_new = fmaxf(m[i], warp_max(s));
      const float alpha = expf(m[i] - m_new);
      p[i] = vis ? expf(s - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int k = 0; k < kDpl; ++k) acc[i][k] *= alpha;
    }
    const int jn = min(kTile, warp_last - t0 + 1);  // uniform across the warp
    for (int j = 0; j < jn; ++j) {
      float vj[kDpl];
#pragma unroll
      for (int k = 0; k < kDpl; ++k) vj[k] = sv[j * D + lane + 32 * k];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(kFullMask, p[i], j);
#pragma unroll
        for (int k = 0; k < kDpl; ++k) acc[i][k] = fmaf(pj, vj[k], acc[i][k]);
      }
    }
  }

  // Key 0 is visible to every row of the chunk, so l > 0.
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (qpos[i] < 0) continue;
    T* o = out + (((size_t)b * C + row0 + wrow + i) * a.heads + h) * D;
#pragma unroll
    for (int k = 0; k < kDpl; ++k) o[lane + 32 * k] = from_float<T>(acc[i][k] / l[i]);
  }
}

struct LaunchPrefill {
  PrefillArgs a;
  int batch;
  cudaStream_t stream;
  template <typename T, int D>
  int operator()() const {
    const dim3 grid(a.heads, batch, (a.chunk + kRows - 1) / kRows);
    prefill_kernel<T, D><<<grid, kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace
}  // namespace adt

// Paged flash prefill (K7).  Returns 0, a cudaError_t, or -1 for an
// unsupported (dtype, head_dim).
extern "C" int adt_flash_prefill_paged(const void* q, const void* k_pool,
                                       const void* v_pool, const int* starts,
                                       const int* table, void* out, int batch, int chunk,
                                       int heads, int block_len, int max_blocks,
                                       int num_blocks, int head_dim, int dtype, float scale,
                                       void* stream) {
  adt::PrefillArgs a{q,     k_pool, v_pool,    starts,     table,      out,
                     chunk, heads,  block_len, max_blocks, num_blocks, scale};
  return adt::dispatch(dtype, head_dim,
                       adt::LaunchPrefill{a, batch, static_cast<cudaStream_t>(stream)});
}
