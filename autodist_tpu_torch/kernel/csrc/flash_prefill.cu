// Paged flash prefill for Hopper: one prompt chunk's C queries per
// (slot, head), causal over everything the block pool holds for the
// slot, online softmax in fp32.
//
// Replaces: autodist_tpu/kernel/pallas/flash_prefill.py,
// _paged_prefill_kernel (K7).  The Pallas kernel runs a (slot, head,
// logical block) grid whose index maps read the scalar-prefetched block
// table, and carries [C, 1] max / sum and a [C, d] accumulator across
// the block axis in VMEM scratch.  Here a thread block owns one (slot,
// head, group of chunk rows), walks the slot's logical blocks itself,
// reading its start and block-table entries, and keeps the per-row
// carries in registers across the walk.  Chunk row r sits at position
// starts[b] + r and sees keys <= starts[b] + r; keys past the block's
// last row are neither loaded nor computed, and a row's masked keys
// weigh p = 0 exactly, as exp(NEG_INF - m) = 0 does in the Pallas
// kernel.  Scores, the softmax and probabilities times values are fp32;
// the output is cast once.
//
// Bound on this card: bytes.  Each visible K/V row is needed once per
// (slot, head) and reused by all C queries, so a chunk does about C / 2
// flops per byte, far under the ~295 flops per byte where bf16 tensor
// cores would bound it; at the serving shapes a block's few 64-key
// tiles make its time mostly latency (loads, then the products, then
// the softmax, in turn).  Two instances, chosen on the host by
// (dtype, block_len, head_dim):
//
// * bf16, head dim 64, block_len a multiple of 8 dividing 64 or a
//   multiple of 64 (prefill_wgmma_kernel): the tensor cores, fed by TMA.
//   A block owns 64 chunk rows (the wgmma M) of one (slot, head): one
//   consumer warpgroup and a producer warp.  The producer loads the Q
//   tile once (a rank-4 tensor map over q [B, C, H, D]; rows at or past
//   C arrive as zeros), then walks the slot's 64-key tiles up to its
//   last visible key: per tile its lanes read the table entries and
//   issue one TMA box a pool block ([block_len rows, 64 dims], or 64
//   rows of a longer block) from rank-4 maps over the [NB, H, bl, D]
//   pools, into a ring of 2 stages with full and empty mbarriers.  A
//   [bl, 64] bf16 block of one head is 2 bl x 64 contiguous bytes in the
//   pool, and boxes of a multiple of 8 rows stack into one
//   128-byte-swizzled 64-row tile, as K1's 64-row boxes do.  The consumer computes
//     S = Q K^T   wgmma m64n64k16 x 4, both operands from shared memory,
//   runs the online softmax on S's accumulator registers (a row's 64
//   scores lie in the 4 threads of a quad: a max is two shuffles), masks
//   only tiles that reach past the block's first row or its last key,
//   and splits p into hi = bf16(p) and lo = bf16(p - hi), so that
//     O += P_hi V + P_lo V   wgmma m64n64k16 x 8, A from registers,
//   keeps p to within 2^-16 relative (one bf16 P: 2^-8), close to the
//   fp32-probability numerics of the Pallas kernel.  A box loads whole
//   pool blocks, and 0 x NaN is NaN in a wgmma, so the consumer clears
//   the staged V rows at or past the last key before the value product
//   (a 128-byte-swizzled row stays at byte 128 r), then fences the
//   generic writes for the async proxy.  About 42 KB of shared memory
//   and 160 threads a block; registers, not shared memory, set the
//   occupancy: the consumer needs about 122 a thread, so 3 blocks share
//   an SM (396 on the card; the serve path's 32 x 16 (slot, head) pairs
//   take 1.3 waves).  On the H100, 4 blocks an SM at 96 registers
//   spilled and walked long slots 18-21 % slower, for 7 % at the serve
//   shape; one warpgroup issuing its own loads (4 blocks an SM, no
//   spill) put the loads on the products' path and walked them 30-39 %
//   slower (PERF.md).  A long slot's walk stays in one block.
// * fp32 (the full-fp32 goldens), and bf16 at any other block length
//   (prefill_kernel): the fp32 CUDA cores.  One thread block per (slot,
//   head, group of 16 chunk rows) stages 32 keys of K and V at a time in
//   shared memory with 16-byte vector loads (rows past the last key its
//   queries see are neither read nor staged); a tile wholly above a
//   warp's rows is skipped.  Each of the 4 warps owns 4 consecutive rows
//   in registers, so one 16-byte read of a staged key (a shared-memory
//   row padded to keep 32 lanes on distinct banks) serves 4 dot
//   products, and one read of a staged value serves 4 accumulators;
//   each lane owns head_dim / 32 output dims.
#include "attention_common.cuh"
#include "hopper.cuh"

namespace adt {
namespace {

// ---------------------------------------------------------------------
// The CUDA-core instance.
// ---------------------------------------------------------------------
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


// ---------------------------------------------------------------------
// The tensor-core instance (bf16, head dim 64).
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kTcRows = 64;  // chunk rows per block: the wgmma M
constexpr int kTcKeys = 64;  // keys per tile: the N of S, the K of P V
constexpr int kTcStages = 2;
constexpr int kTcThreads = 128 + 32;  // a consumer warpgroup and the producer warp
constexpr int kTcTile = 64 * 128;     // bytes of a 64-row tile of D = 64
constexpr int kTcBytes = (1 + 2 * kTcStages) * kTcTile + 8 * (1 + 3 * kTcStages) + 1024;

// Block lengths the tensor-core instance takes: whole boxes stack into a
// 64-row tile (a multiple of 8 dividing 64), or a tile lies in one block
// (a multiple of 64).
__host__ __device__ constexpr bool tc_block_len(int bl) {
  return bl > 0 && (bl % kTcKeys == 0 || (bl % 8 == 0 && kTcKeys % bl == 0));
}

// One tile's online softmax on this thread's 32 scores s[4 j + 2 h + e]
// (row pos[h], key col0 + 8 j + e): scaled to log2 units, masked (when
// kMask) past the row's position and at or past n_keys, exponentiated in
// place; m, l and the accumulator o rescaled.
template <bool kMask>
__device__ __forceinline__ void tc_softmax(float (&s)[32], float (&o)[32], float (&m)[2],
                                           float (&l)[2], const int (&pos)[2], int col0,
                                           int n_keys, float c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x *= c;
        if (kMask) {
          const int col = col0 + 8 * j + e;
          if (col > pos[h] || col >= n_keys) x = kNegInf;
        }
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
    // Key 0 is visible to every row and lies in tile 0, so m is finite
    // from the first tile on and a masked score weighs exp2(kNegInf - m)
    // = 0.
    const float m_new = fmaxf(m[h], mx);
    const float alpha = hopper::fast_exp2(m[h] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = hopper::fast_exp2(x - m_new);
        sum += x;
      }
    }
    l[h] = l[h] * alpha + sum;
    m[h] = m_new;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j + 2 * h] *= alpha;
      o[4 * j + 2 * h + 1] *= alpha;
    }
  }
}

// 3 blocks an SM: 128 registers a thread, which the consumer needs.
__global__ void __launch_bounds__(kTcThreads, 3)
    prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, PrefillArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sK = sQ + kTcTile;               // [stage]
  unsigned char* sV = sK + kTcStages * kTcTile;   // [stage]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kTcStages * kTcTile);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kTcStages;
  uint64_t* empty = v_full + kTcStages;

  const int h = blockIdx.x, b = blockIdx.y, row0 = blockIdx.z * kTcRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bl = a.block_len;
  const int start = a.starts[b];
  // Keys the block's last row sees: [0, n_keys).
  const int n_keys = min(start + min(a.chunk, row0 + kTcRows), a.max_blocks * bl);
  const int tiles = (n_keys + kTcKeys - 1) / kTcKeys;
  const float scale_log2 = a.scale * hopper::kLog2e;  // scores in log2 units
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer: lane i issues the tile's box i
    const int* row_table = a.table + (size_t)b * a.max_blocks;
    const int box = min(bl, kTcKeys);  // rows per box
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(q_full, kTcTile);
      hopper::tma_load_4d(sQ, &tq, q_full, 0, row0, h, b);
    }
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kTcStages, t0 = t * kTcKeys;
      // Boxes up to the last key; whole blocks past it are not loaded.
      const int boxes = (min(kTcKeys, n_keys - t0) + box - 1) / box;
      if (t >= kTcStages) hopper::mbar_wait(&empty[s], (t / kTcStages - 1) & 1);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&k_full[s], boxes * box * 128);
        hopper::mbar_arrive_expect_tx(&v_full[s], boxes * box * 128);
      }
      __syncwarp();
      if (lane < boxes) {
        const int key = t0 + lane * box;
        const int blk = __ldg(row_table + key / bl);
        const int off = s * kTcTile + lane * box * 128;
        hopper::tma_load_4d(sK + off, &tk, &k_full[s], 0, key % bl, h, blk);
        hopper::tma_load_4d(sV + off, &tv, &v_full[s], 0, key % bl, h, blk);
      }
    }
    return;
  }

  // The consumer warpgroup: this thread's two rows of the block.
  const int r = warp * 16 + (lane >> 2);
  const int pos[2] = {start + row0 + r, start + row0 + r + 8};
  // Tiles reaching past this key need the mask.
  const int unmasked_end = min(start + row0 + 1, n_keys);
  float o[32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  hopper::mbar_wait(q_full, 0);

  for (int t = 0; t < tiles; ++t) {
    const int s = t % kTcStages, t0 = t * kTcKeys;
    const uint32_t parity = (t / kTcStages) & 1;
    const unsigned char* kt = sK + s * kTcTile;
    unsigned char* vt = sV + s * kTcTile;
    float sc[32];
    hopper::mbar_wait(&k_full[s], parity);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n64k16_ss(sc, hopper::desc_sw128(sQ + 32 * kk, 16, 1024),
                                 hopper::desc_sw128(kt + 32 * kk, 16, 1024), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    const int col0 = t0 + 2 * (lane & 3);
    if (t0 + kTcKeys > unmasked_end)
      tc_softmax<true>(sc, o, m, l, pos, col0, n_keys, scale_log2);
    else
      tc_softmax<false>(sc, o, m, l, pos, col0, n_keys, scale_log2);

    // p = hi + lo as bf16 pairs: the A fragments, 4 per 16 keys.
    uint32_t hi[16], lo[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      hi[i] = hopper::pack_bf16(sc[2 * i], sc[2 * i + 1]);
      const float2 back =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi[i]));
      lo[i] = hopper::pack_bf16(sc[2 * i] - back.x, sc[2 * i + 1] - back.y);
    }
    hopper::mbar_wait(&v_full[s], parity);
    if (t0 + kTcKeys > n_keys) {  // the last tile: clear V rows past the last key
      for (int c = (n_keys - t0) * 8 + threadIdx.x; c < kTcKeys * 8; c += 128)
        reinterpret_cast<uint4*>(vt)[c] = make_uint4(0, 0, 0, 0);
      hopper::fence_proxy_async();
      hopper::bar_sync(1, 128);
    }
    hopper::fence_regs(o);
    hopper::fence_regs(hi);
    hopper::fence_regs(lo);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t frag[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3]};
      hopper::wgmma_m64n64k16_rs<1>(o, frag, hopper::desc_sw128(vt + 2048 * kk, 1024, 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t frag[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3]};
      hopper::wgmma_m64n64k16_rs<1>(o, frag, hopper::desc_sw128(vt + 2048 * kk, 1024, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();  // the stage is read: release it
    hopper::fence_regs(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(kFullMask, l[hh], 1);
    l[hh] += __shfl_xor_sync(kFullMask, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + r + 8 * hh;
    if (row >= a.chunk) continue;
    bf16* dst = static_cast<bf16*>(a.out) + (((size_t)b * a.chunk + row) * a.heads + h) * 64 +
                2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] / l[hh], o[4 * j + 2 * hh + 1] / l[hh]);
  }
}

// The tensor-core instance: tensor maps over q and the pools, encoded
// per call; a grid of (heads, B, 64-row groups).
int launch_wgmma(const PrefillArgs& a, int batch, cudaStream_t stream) {
  static bool configured[hopper::kMaxDevices] = {};
  const cuuint64_t row = 64 * 2;  // bytes of one head's row
  const cuuint64_t q_dims[4] = {64, static_cast<cuuint64_t>(a.chunk),
                                static_cast<cuuint64_t>(a.heads),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t q_strides[3] = {a.heads * row, row, a.chunk * a.heads * row};
  const cuuint32_t q_box[4] = {64, kTcRows, 1, 1};
  const cuuint64_t p_dims[4] = {64, static_cast<cuuint64_t>(a.block_len),
                                static_cast<cuuint64_t>(a.heads),
                                static_cast<cuuint64_t>(a.num_blocks)};
  const cuuint64_t p_strides[3] = {row, a.block_len * row, a.heads * a.block_len * row};
  const cuuint32_t box_rows = a.block_len < kTcKeys ? a.block_len : kTcKeys;
  const cuuint32_t p_box[4] = {64, box_rows, 1, 1};
  CUtensorMap tq, tk, tv;
  if (!hopper::encode_bf16(&tq, a.q, q_dims, q_strides, q_box) ||
      !hopper::encode_bf16(&tk, a.k, p_dims, p_strides, p_box) ||
      !hopper::encode_bf16(&tv, a.v, p_dims, p_strides, p_box))
    return hopper::kEncodeFailed;
  const int rc = hopper::allow_smem(prefill_wgmma_kernel, kTcBytes, configured);
  if (rc) return rc;
  const dim3 grid(a.heads, batch, (a.chunk + kTcRows - 1) / kTcRows);
  prefill_wgmma_kernel<<<grid, kTcThreads, kTcBytes, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace adt

// Paged flash prefill (K7).  tensor_cores selects the wgmma instance
// (bf16, head dim 64, a block length tc_block_len takes), else the
// CUDA-core one.  Returns 0, a cudaError_t, -1 for a (dtype, head_dim,
// block_len) the chosen instance does not take, or -2 if a tensor map
// was refused.
extern "C" int adt_flash_prefill_paged(const void* q, const void* k_pool,
                                       const void* v_pool, const int* starts,
                                       const int* table, void* out, int batch, int chunk,
                                       int heads, int block_len, int max_blocks,
                                       int num_blocks, int head_dim, int dtype,
                                       int tensor_cores, float scale, void* stream) {
  adt::PrefillArgs a{q,     k_pool, v_pool,    starts,     table,      out,
                     chunk, heads,  block_len, max_blocks, num_blocks, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (dtype != adt::kBF16 || head_dim != 64 || !adt::tc_block_len(block_len)) return -1;
    return adt::launch_wgmma(a, batch, s);
  }
  return adt::dispatch(dtype, head_dim, adt::LaunchPrefill{a, batch, s});
}
