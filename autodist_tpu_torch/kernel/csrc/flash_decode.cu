// Flash decode for Hopper: one query per (slot, head) against a dense
// cache lane or a paged block pool, online softmax in fp32.
//
// Replaces: autodist_tpu/kernel/pallas/flash_decode.py, _decode_kernel
// (dense, K5) and _paged_decode_kernel (paged, K6).  The Pallas kernels
// run a (slot, head) grid — plus a sequential logical-block axis in the
// paged one — and carry the running max / sum / accumulator across grid
// steps in VMEM scratch, with the block table scalar-prefetched into
// SMEM.  Here one thread block takes a (slot, head): it reads its slot's
// length and, paged, its own block-table entries, masks the ragged tail
// itself (no zero-padding of T) and never reads a key past the last
// visible one — masked keys would contribute exactly exp(NEG_INF - m) =
// 0, so the result is the same, and their values (stale rows of an
// earlier occupant, possibly NaN) are never read.
//
// Bound on this card: bytes.  A call reads each visible key's K and V
// row once (2 * (length + 1) * head_dim * sizeof(T) bytes per (slot,
// head)) and does 4 * head_dim flops per key, about one flop per byte
// at bf16, far below the ~295 flops per byte where the tensor cores
// would bound it.  So nothing goes to tensor cores or TMA (whose tensor
// maps are encoded on the host, on a host-bound path).  What limits a
// call is how many keys each block has in flight: a block walks its
// slot as a chain of round trips to memory, so the design keeps many
// keys in flight and does little between them.
//
// * Coalesced, double-buffered tiles.  Each of a block's 8 warps owns a
//   tile of the block's chunk (16 keys at bf16 and 8 at fp32 over dense
//   lanes; 12 and 6 over a paged pool) and a private ring of two stages
//   in shared memory, so tile i + 1 is in flight while tile i is scored.
//   Warps never wait for each other before the merge.  A key's row is
//   kLpk 16-byte pieces (8 at bf16, 16 at fp32) and kLpk neighbouring
//   lanes copy them with cp.async: one copy instruction of the warp
//   moves 512 contiguous bytes.  Rows past the slot's last key are
//   zero-filled without a read.  The same lanes score the key from
//   shared memory (one 16-byte read each, a contiguous 512 bytes a warp:
//   no bank conflict, no swizzle) with a dot product split over kLpk
//   lanes and a shuffle reduction, then accumulate P.V, each lane owning
//   16 bytes' worth of output dims; every lane reads back only what it
//   copied itself.  The dense ring is 64 KB (3 blocks an SM, 256 keys
//   of a block in flight at bf16: a serve-mix slot in one round trip);
//   the paged one 48 KB, so that 4 blocks share an SM and the paged
//   serve mix's 512 (slot, head) pairs run in one wave on 132 SMs.
// * Paged table staging.  A warp loads its tile's block-table entries
//   once, one per lane in one coalesced load (prefetched a tile ahead),
//   and a row's pool block comes from a shuffle, not from a table read
//   per key.  A pool block of bl rows is contiguous at ((blk * H + h) *
//   bl) * D.
// * No split of a (slot, head) over blocks.  Measured on an H100
//   (PERF.md): splitting a long slot over up to 8 blocks that merge
//   through a scratch buffer and a counter, or over a cluster through
//   distributed shared memory, was slower on the serve path at 8 and 32
//   slots and in three of four traffic mixes at 4, and won clearly only
//   with one slot.
//
// Statistics and accumulator are fp32 whatever the cache type; the
// output is cast to the cache type once.
#include "attention_common.cuh"

namespace adt {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;     // tiles in flight per warp
// Key groups per warp tile: 4 over dense lanes (a 64 KB ring, 3 blocks
// an SM), 3 over a paged pool (48 KB, 4 blocks an SM), so that the
// paged serve mix's 512 (slot, head) pairs take one wave of 132 SMs.
constexpr int kDenseSteps = 4;
constexpr int kPagedSteps = 3;
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

// The tile shape of one (element type, head dim, layout).
template <typename T, int D, bool kPaged>
struct Tile {
  static constexpr int kSteps = kPaged ? kPagedSteps : kDenseSteps;
  static constexpr int kVec = 16 / sizeof(T);       // elements a piece
  static constexpr int kLpk = D / kVec;             // lanes a key
  static constexpr int kGroups = 32 / kLpk;         // keys a warp step
  static constexpr int kKeys = kGroups * kSteps;    // keys a warp tile
  static constexpr int kChunk = kWarps * kKeys;     // keys a block step
  static constexpr int kElems = kKeys * D;          // elements a tile
  static constexpr int kSmemBytes = kWarps * kStages * 2 * kElems * sizeof(T);
  static_assert(D % kVec == 0 && 32 % kLpk == 0, "a row must split over lanes");
};

// 16-byte global -> shared copy; src_bytes = 0 zero-fills without a read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum (Max = false) or max over the lanes whose index differs only in
// the bits from First up (xor First, 2 First, ..., 16).
template <int First, bool Max>
__device__ __forceinline__ float lane_reduce(float x) {
#pragma unroll
  for (int o = First; o < 32; o <<= 1) {
    const float y = __shfl_xor_sync(kFullMask, x, o);
    x = Max ? fmaxf(x, y) : x + y;
  }
  return x;
}

template <typename T, int D, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  using Tl = Tile<T, D, kPaged>;
  constexpr int kVec = Tl::kVec, kLpk = Tl::kLpk, kGroups = Tl::kGroups;
  constexpr int kSteps = Tl::kSteps;
  constexpr int kKeys = Tl::kKeys, kChunk = Tl::kChunk;
  static_assert(D <= kThreads, "a thread a head dim in the merge");
  const int h = blockIdx.x, b = blockIdx.y;
  const int bh = b * a.heads + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / kLpk, s = lane % kLpk;  // key group, piece of the row
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int extent = kPaged ? a.max_blocks * a.extent : a.extent;
  const int bl = a.extent;
  const int first = warp * kKeys;  // this warp's first key

  // Paged: lane i holds the table entry of logical block t0 / bl + i.
  auto table_entries = [&](int t0) {
    int e = 0;
    if (kPaged && t0 < extent) {
      const int e0 = t0 / bl, n = (t0 % bl + kKeys - 1) / bl + 1;
      if (lane < n && e0 + lane < a.max_blocks)
        e = __ldg(a.table + (size_t)b * a.max_blocks + e0 + lane);
    }
    return e;
  };
  // The length, q and tile 0's entries are loaded together: none of
  // them reads a key.
  const int n_vis = min(__ldg(a.lengths + b) + 1, extent);  // keys [0, n_vis)
  const int ent0 = table_entries(first);
  float qf[kVec];
  {
    const uint4 raw = __ldg(
        reinterpret_cast<const uint4*>(static_cast<const T*>(a.q) + (size_t)bh * D) + s);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) qf[j] = to_float(e[j]);
  }

  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ __align__(16) float s_acc[kWarps][D];
  // This warp's ring: kStages x (K tile, V tile), each [kKeys][D].
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw) + (size_t)warp * kStages * 2 * Tl::kElems;

  // This warp's tiles: t0 = first + j * kChunk, j = 0, 1, ...
  const int n_tiles = first < n_vis ? (n_vis - 1 - first) / kChunk + 1 : 0;

  // Copies tile j (first key t0) into stage j % kStages: this lane's
  // piece s of rows g + kGroups * i, K and V.
  auto issue = [&](int j, int ent) {
    const int t0 = first + j * kChunk;
    T* kt = ring + (j % kStages) * 2 * Tl::kElems;
    T* vt = kt + Tl::kElems;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int r = g + kGroups * i, t = t0 + r;
      size_t row;
      if (kPaged) {
        int blk = __shfl_sync(kFullMask, ent, t / bl - t0 / bl);
        blk = min(max(blk, 0), a.num_blocks - 1);  // memory safety only
        row = ((size_t)blk * a.heads + h) * bl + t % bl;
      } else {
        row = (size_t)bh * a.extent + t;
      }
      // A row past the last key is zero-filled from no address read.
      const int bytes = t < n_vis ? 16 : 0;
      if (!bytes) row = kPaged ? 0 : (size_t)bh * a.extent;
      cp_async16(kt + r * D + s * kVec, k + row * D + s * kVec, bytes);
      cp_async16(vt + r * D + s * kVec, v + row * D + s * kVec, bytes);
    }
  };

  int ent[kStages];
  ent[0] = ent0;
#pragma unroll
  for (int j = 1; j < kStages; ++j) ent[j] = table_entries(first + j * kChunk);
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (j < n_tiles) issue(j, ent[j]);
    cp_async_commit();
  }

  float m = kNegInf, l = 0.f, acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = first + j * kChunk;
    const int next = j + kStages;  // the tile that takes this one's stage
    const int ent_next = next < n_tiles ? table_entries(t0 + kStages * kChunk) : 0;
    cp_async_wait<kStages - 1>();  // tile j has landed (this lane's copies)
    const T* kt = ring + (j % kStages) * 2 * Tl::kElems;
    const T* vt = kt + Tl::kElems;
    float sc[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int r = g + kGroups * i;
      const uint4 raw = *reinterpret_cast<const uint4*>(kt + r * D + s * kVec);
      const T* e = reinterpret_cast<const T*>(&raw);
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) d = fmaf(qf[c], to_float(e[c]), d);
#pragma unroll
      for (int o = 1; o < kLpk; o <<= 1) d += __shfl_xor_sync(kFullMask, d, o);
      sc[i] = t0 + r < n_vis ? d * a.scale : kNegInf;
    }
    float mx = sc[0];
#pragma unroll
    for (int i = 1; i < kSteps; ++i) mx = fmaxf(mx, sc[i]);
    // Key t0 is visible, so m_new is finite from the first tile on.
    const float m_new = fmaxf(m, lane_reduce<kLpk, true>(mx));
    const float alpha = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      sc[i] = t0 + g + kGroups * i < n_vis ? expf(sc[i] - m_new) : 0.f;
      ps += sc[i];
    }
    l = l * alpha + lane_reduce<kLpk, false>(ps);
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] *= alpha;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int r = g + kGroups * i;
      const uint4 raw = *reinterpret_cast<const uint4*>(vt + r * D + s * kVec);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[c] = fmaf(sc[i], to_float(e[c]), acc[c]);
    }
    m = m_new;
    __syncwarp();  // the stage is read before tile `next` overwrites it
    if (next < n_tiles) issue(next, ent_next);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // The warp's groups hold partial sums of one state: add them up.
#pragma unroll
  for (int c = 0; c < kVec; ++c) acc[c] = lane_reduce<kLpk, false>(acc[c]);
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  if (g == 0) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) s_acc[warp][s * kVec + c] = acc[c];
  }
  __syncthreads();

  // The output from the warps' states; a warp that saw no tile holds
  // (NEG_INF, 0, 0) and weighs exp(NEG_INF - M) = 0.
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
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
    static_cast<T*>(a.out)[(size_t)bh * D + d] = from_float<T>(n_vis > 0 ? A / L : 0.f);
  }
}

template <bool kPaged>
struct LaunchDecode {
  DecodeArgs a;
  int batch;
  cudaStream_t stream;
  template <typename T, int D>
  int operator()() const {
    auto kernel = decode_kernel<T, D, kPaged>;
    const int bytes = Tile<T, D, kPaged>::kSmemBytes;
    // The shared-memory limit is an attribute of the kernel on each
    // device: raise it once per device this instantiation runs on.
    static bool configured[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices || !configured[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) configured[dev] = true;
    }
    kernel<<<dim3(a.heads, batch), kThreads, bytes, stream>>>(a);
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
