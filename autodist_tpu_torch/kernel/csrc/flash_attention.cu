// Flash attention for Hopper: the forward (K1) and the two backward
// kernels (K2a: dq, K2b: dk and dv) of self-attention over
// q, k, v [B, L, H, D], with fp32 statistics.
//
// Replaces: autodist_tpu/ops/flash_attention.py, _fwd_kernel (K1),
// _bwd_dq_kernel (K2a) and _bwd_dkv_kernel (K2b).  The Pallas kernels
// run a (batch*head, block) grid over inputs the wrapper has padded to a
// block multiple with heads folded into batch, and carry the online
// softmax (K1) or the fp32 accumulators (K2) across an inner fori_loop
// in VMEM.  Here each thread block owns one (batch, head, tile) and
// loops over the other axis itself; q, k and v are read where they lie
// (the strides of a [B, L, 3, H, D] projection are passed in), and the
// ragged end of L is masked in the kernel instead of padded.  The
// numerics follow the Pallas kernels: scores and statistics in fp32,
// masked scores at the finite float32 minimum, p cast to the input
// dtype before the value product (K1), p and ds cast to the input dtype
// before their products (K2), fp32 lse = m + log l, and fp32 dq, dk, dv
// (the wrapper computes delta = rowsum(g * out) and casts the
// gradients back).
//
// Bound on this card: at BERT-base shapes (L = 512, D = 64, bf16) each
// kernel does about 254 flops per byte it must move, just under the
// H100's ridge of some 295, so bytes bound it formally and the bf16
// tensor cores nearly as much; in fp32 (67 TFLOP/s without tensor
// cores) operations bound it.  Two designs, one per dtype:
//
// * fp32 (the *_kernel below): the fp32 CUDA cores, plain FMAs, so
//   the CPU goldens' full fp32 precision holds (no TF32).  Tiles are
//   staged as fp32 (q, k, g transposed so that one 16-byte read gives 4
//   rows), and each of the 128 threads of a block owns a 4 x 4 block of
//   the score tile and a 4 x 8 block of the output, so a pair of 16-byte
//   shared reads feeds 16 FMAs;
// * bf16: K1 (fwd_wgmma_kernel) on Hopper's wgmma, fed by a TMA ring
//   and keeping S, P and O in registers, see its section; K2a and K2b
//   (the *_tc_kernel below) on the same blocks as fp32 with the products
//   as WMMA (fp32 accumulation) and the softmax work on the CUDA cores.
//
// wgmma with a TMA ring for K2a and K2b is later work.
#include <mma.h>

#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace adt {
namespace {

constexpr int kD = 64;         // head dim (BERT-base: 768 / 12)
constexpr int kThreads = 128;  // 16 row groups (ty) x 8 column groups (tx)
constexpr int kBQ = 64;        // K1, K2a: query rows per block
constexpr int kBK = 32;        // K1, K2a: keys per tile
constexpr int kBKV = 64;       // K2b: keys per block
constexpr int kBQ2 = 32;       // K2b: query rows per tile
constexpr int kLdP = kBQ + 4;  // row pitch of a staged [keys][rows] tile
constexpr int kLdP2 = kBKV + 4;

struct AttnArgs {
  const void* q;  // [B, L, H, D], strides (sb, sl, sh) shared by q, k, v
  const void* k;
  const void* v;
  long long sb, sl, sh;
  const void* g;        // [B, L, H, D] contiguous (K2)
  void* out;            // [B, L, H, D] contiguous, input dtype (K1)
  float* lse;           // [B, L, H] (written by K1, read by K2)
  const float* delta;   // [B, L, H] (K2)
  float* dq;            // [B, L, H, D] fp32 (K2a)
  float* dk;            // [B, L, H, D] fp32 (K2b)
  float* dv;
  int batch, len, heads;
  float scale;
  int causal;
};

// Rows [row0, row0 + ROWS) of one (batch, head) into shared memory as
// fp32, transposed: dst[d * ROWS + r].  Rows at or past len read as 0.
// Consecutive threads take consecutive rows, so the transposed stores
// fall on distinct banks.
template <typename T, int ROWS>
__device__ __forceinline__ void stage_t(float* dst, const T* base, long long sl, int row0,
                                        int len) {
  constexpr int kVec = 16 / sizeof(T);
  for (int c = threadIdx.x; c < ROWS * (kD / kVec); c += kThreads) {
    const int r = c % ROWS, d0 = (c / ROWS) * kVec;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < len)
      raw = __ldg(reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * sl + d0));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[(d0 + i) * ROWS + r] = to_float(e[i]);
  }
}

// The same rows row-major: dst[r * kD + d].
template <typename T, int ROWS>
__device__ __forceinline__ void stage_r(float* dst, const T* base, long long sl, int row0,
                                        int len) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kD / kVec;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, d0 = (c % kChunks) * kVec;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < len)
      raw = __ldg(reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * sl + d0));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * kD + d0 + i] = to_float(e[i]);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// acc[i][j] += a[i] * b[j] for 4 x 4.
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4& a, const float4& b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ai = at(a, i);
    acc[i][0] = fmaf(ai, b.x, acc[i][0]);
    acc[i][1] = fmaf(ai, b.y, acc[i][1]);
    acc[i][2] = fmaf(ai, b.z, acc[i][2]);
    acc[i][3] = fmaf(ai, b.w, acc[i][3]);
  }
}

// acc[i][0..8) += w[i] * (lo, hi) for the thread's 8 output dims
// (4tx..4tx+3 and 32+4tx..32+4tx+3).
__device__ __forceinline__ void outer48(float (&acc)[4][8], const float4& w, const float4& lo,
                                        const float4& hi) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float wi = at(w, i);
    acc[i][0] = fmaf(wi, lo.x, acc[i][0]);
    acc[i][1] = fmaf(wi, lo.y, acc[i][1]);
    acc[i][2] = fmaf(wi, lo.z, acc[i][2]);
    acc[i][3] = fmaf(wi, lo.w, acc[i][3]);
    acc[i][4] = fmaf(wi, hi.x, acc[i][4]);
    acc[i][5] = fmaf(wi, hi.y, acc[i][5]);
    acc[i][6] = fmaf(wi, hi.z, acc[i][6]);
    acc[i][7] = fmaf(wi, hi.w, acc[i][7]);
  }
}

// Max and sum over the 8 lanes (tx) that share a row group.
__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  x += __shfl_xor_sync(kFullMask, x, 2);
  return x + __shfl_xor_sync(kFullMask, x, 4);
}

__device__ __forceinline__ bool masked(int row, int col, int len, int causal) {
  return col >= len || row >= len || (causal && col > row);
}

// Writes the thread's 8 dims of one output row, each divided by div.
template <typename T>
__device__ __forceinline__ void store_row8(T* dst, const float (&x)[8], float div) {
  const int tx = threadIdx.x & 7;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dst[4 * tx + e] = from_float<T>(x[e] / div);
    dst[32 + 4 * tx + e] = from_float<T>(x[4 + e] / div);
  }
}

// ---------------------------------------------------------------------
// K1: one block per (batch * head, 64 query rows), key tiles of 32.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) fwd_kernel(AttnArgs a) {
  using T = float;
  __shared__ __align__(16) float sQt[kD * kBQ];
  __shared__ __align__(16) float sKt[kD * kBK];
  __shared__ __align__(16) float sV[kBK * kD];
  __shared__ __align__(16) float sP[kBK * kLdP];  // p transposed: [key][row]

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * kBQ;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const long long off = (long long)b * a.sb + (long long)h * a.sh;
  const T* q = static_cast<const T*>(a.q) + off;
  const T* k = static_cast<const T*>(a.k) + off;
  const T* v = static_cast<const T*>(a.v) + off;
  stage_t<T, kBQ>(sQt, q, a.sl, q0, a.len);

  // Key tiles past the block's last row are skipped when causal.
  const int n_keys = a.causal ? min(a.len, q0 + kBQ) : a.len;
  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();  // the previous tile has been read
    stage_t<T, kBK>(sKt, k, a.sl, k0, a.len);
    stage_r<T, kBK>(sV, v, a.sl, k0, a.len);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < kD; ++d) outer4(s, ld4(sQt + d * kBQ + 4 * ty), ld4(sKt + d * kBK + 4 * tx));

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        // Rows past len are computed on zeros and never written.
        s[i][j] = (col >= a.len || (a.causal && col > row)) ? kNegInf : s[i][j] * a.scale;
        mx = fmaxf(mx, s[i][j]);
      }
      // Key 0 is visible to every row, so m is finite from the first
      // tile on and a masked score weighs exp(NEG_INF - m) = 0.
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        s[i][j] = p;
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sP + (4 * tx + j) * kLdP + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c)
      outer48(acc, ld4(sP + c * kLdP + 4 * ty), ld4(sV + c * kD + 4 * tx),
              ld4(sV + c * kD + 32 + 4 * tx));
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.len) continue;
    const long long r = (long long)b * a.len + row;
    store_row8<T>(out + (r * a.heads + h) * kD, acc[i], l[i]);
    if (tx == 0) a.lse[r * a.heads + h] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------
// K2a: one block per (batch * head, 64 query rows), key tiles of 32;
// dq = sum over keys of ds * k, recomputing p = exp(s - lse).
// ---------------------------------------------------------------------
constexpr int kDqSmemFloats = 2 * kD * kBQ + 3 * kD * kBK + kBK * kLdP;

__global__ void __launch_bounds__(kThreads) dq_kernel(AttnArgs a) {
  using T = float;
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;            // [kD][kBQ]
  float* sGt = sQt + kD * kBQ;  // [kD][kBQ]
  float* sKt = sGt + kD * kBQ;  // [kD][kBK]
  float* sVt = sKt + kD * kBK;  // [kD][kBK]
  float* sK = sVt + kD * kBK;   // [kBK][kD]
  float* sDS = sK + kBK * kD;   // ds transposed: [key][row]

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * kBQ;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const long long off = (long long)b * a.sb + (long long)h * a.sh;
  const T* q = static_cast<const T*>(a.q) + off;
  const T* k = static_cast<const T*>(a.k) + off;
  const T* v = static_cast<const T*>(a.v) + off;
  const T* g = static_cast<const T*>(a.g) + ((long long)b * a.len * a.heads + h) * kD;
  stage_t<T, kBQ>(sQt, q, a.sl, q0, a.len);
  stage_t<T, kBQ>(sGt, g, (long long)a.heads * kD, q0, a.len);

  float lse[4], delta[4], dq[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const long long r = ((long long)b * a.len + row) * a.heads + h;
    lse[i] = row < a.len ? a.lse[r] : 0.f;
    delta[i] = row < a.len ? a.delta[r] : 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) dq[i][e] = 0.f;
  }

  const int n_keys = a.causal ? min(a.len, q0 + kBQ) : a.len;
  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();
    stage_t<T, kBK>(sKt, k, a.sl, k0, a.len);
    stage_t<T, kBK>(sVt, v, a.sl, k0, a.len);
    stage_r<T, kBK>(sK, k, a.sl, k0, a.len);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      const float4 kk = ld4(sKt + d * kBK + 4 * tx);
      const float4 vv = ld4(sVt + d * kBK + 4 * tx);
      outer4(s, ld4(sQt + d * kBQ + 4 * ty), kk);
      outer4(dp, ld4(sGt + d * kBQ + 4 * ty), vv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        const float x = (col >= a.len || (a.causal && col > row)) ? kNegInf : s[i][j] * a.scale;
        const float p = expf(x - lse[i]);
        s[i][j] = p * (dp[i][j] - delta[i]) * a.scale;  // ds
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sDS + (4 * tx + j) * kLdP + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c)
      outer48(dq, ld4(sDS + c * kLdP + 4 * ty), ld4(sK + c * kD + 4 * tx),
              ld4(sK + c * kD + 32 + 4 * tx));
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.len) continue;
    store_row8<float>(a.dq + (((long long)b * a.len + row) * a.heads + h) * kD, dq[i], 1.f);
  }
}

// ---------------------------------------------------------------------
// K2b: one block per (batch * head, 64 keys), query tiles of 32 from
// the diagonal on when causal; dv = sum p * g and dk = sum ds * q.
// ---------------------------------------------------------------------
constexpr int kDkvSmemFloats = 2 * kD * kBKV + 4 * kD * kBQ2 + 2 * kBQ2 * kLdP2 + 2 * kBQ2;

__global__ void __launch_bounds__(kThreads) dkv_kernel(AttnArgs a) {
  using T = float;
  extern __shared__ __align__(16) float smem[];
  float* sKt = smem;                 // [kD][kBKV], resident
  float* sVt = sKt + kD * kBKV;      // [kD][kBKV], resident
  float* sQt = sVt + kD * kBKV;      // [kD][kBQ2]
  float* sGt = sQt + kD * kBQ2;      // [kD][kBQ2]
  float* sQ = sGt + kD * kBQ2;       // [kBQ2][kD]
  float* sG = sQ + kBQ2 * kD;        // [kBQ2][kD]
  float* sP = sG + kBQ2 * kD;        // p: [row][key]
  float* sDS = sP + kBQ2 * kLdP2;    // ds: [row][key]
  float* sLse = sDS + kBQ2 * kLdP2;  // [kBQ2]
  float* sDelta = sLse + kBQ2;       // [kBQ2]

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int kb0 = blockIdx.x * kBKV;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;  // keys 4ty.., rows 4tx..
  const long long off = (long long)b * a.sb + (long long)h * a.sh;
  const long long sg = (long long)a.heads * kD;
  const T* q = static_cast<const T*>(a.q) + off;
  const T* k = static_cast<const T*>(a.k) + off;
  const T* v = static_cast<const T*>(a.v) + off;
  const T* g = static_cast<const T*>(a.g) + ((long long)b * a.len * a.heads + h) * kD;
  stage_t<T, kBKV>(sKt, k, a.sl, kb0, a.len);
  stage_t<T, kBKV>(sVt, v, a.sl, kb0, a.len);

  float dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) dk[i][e] = dv[i][e] = 0.f;

  // Query tiles wholly above the diagonal see none of these keys.
  const int qstart = a.causal ? (kb0 / kBQ2) * kBQ2 : 0;
  for (int q0 = qstart; q0 < a.len; q0 += kBQ2) {
    __syncthreads();
    stage_t<T, kBQ2>(sQt, q, a.sl, q0, a.len);
    stage_t<T, kBQ2>(sGt, g, sg, q0, a.len);
    stage_r<T, kBQ2>(sQ, q, a.sl, q0, a.len);
    stage_r<T, kBQ2>(sG, g, sg, q0, a.len);
    if (threadIdx.x < kBQ2) {
      const int row = q0 + threadIdx.x;
      const long long r = ((long long)b * a.len + row) * a.heads + h;
      sLse[threadIdx.x] = row < a.len ? a.lse[r] : 0.f;
      sDelta[threadIdx.x] = row < a.len ? a.delta[r] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};  // [key i][row j]
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      const float4 qq = ld4(sQt + d * kBQ2 + 4 * tx);
      const float4 gg = ld4(sGt + d * kBQ2 + 4 * tx);
      outer4(s, ld4(sKt + d * kBKV + 4 * ty), qq);
      outer4(dp, ld4(sVt + d * kBKV + 4 * ty), gg);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + 4 * tx + j;
      const float lse = sLse[4 * tx + j], delta = sDelta[4 * tx + j];
      float p4[4], ds4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = masked(row, kb0 + 4 * ty + i, a.len, a.causal) ? kNegInf
                                                                        : s[i][j] * a.scale;
        const float p = expf(x - lse);
        p4[i] = p;
        ds4[i] = p * (dp[i][j] - delta) * a.scale;
      }
      *reinterpret_cast<float4*>(sP + (4 * tx + j) * kLdP2 + 4 * ty) =
          make_float4(p4[0], p4[1], p4[2], p4[3]);
      *reinterpret_cast<float4*>(sDS + (4 * tx + j) * kLdP2 + 4 * ty) =
          make_float4(ds4[0], ds4[1], ds4[2], ds4[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kBQ2; ++r) {
      outer48(dv, ld4(sP + r * kLdP2 + 4 * ty), ld4(sG + r * kD + 4 * tx),
              ld4(sG + r * kD + 32 + 4 * tx));
      outer48(dk, ld4(sDS + r * kLdP2 + 4 * ty), ld4(sQ + r * kD + 4 * tx),
              ld4(sQ + r * kD + 32 + 4 * tx));
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = kb0 + 4 * ty + i;
    if (key >= a.len) continue;
    const long long o = (((long long)b * a.len + key) * a.heads + h) * kD;
    store_row8<float>(a.dk + o, dk[i], 1.f);
    store_row8<float>(a.dv + o, dv[i], 1.f);
  }
}

// ---------------------------------------------------------------------
// bf16 backward on the tensor cores.  The same blocks as the kernels
// above (64 query rows for K2a, 64 keys for K2b), walking 64-wide tiles
// of the other axis: each block stages bf16 tiles as they lie in
// memory, each warp runs the products of its 16 rows or keys as
// 16x16x16 WMMA with fp32 accumulation, and the products' fp32 tiles
// pass through shared memory to the threads that own those rows, which
// do the softmax work on the CUDA cores as above and write p and ds
// back as bf16 (the Pallas kernels' casts) for the next product.  Row
// pitches of 72 bf16 (144 bytes) and 68 fp32 keep WMMA's row loads on
// distinct banks.
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;
namespace wm = nvcuda::wmma;
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragBRow = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragBCol = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

constexpr int kT = 64;                 // rows and keys per tile
constexpr int kLdH = kT + 8;           // bf16 row pitch
constexpr int kLdF = kT + 4;           // fp32 row pitch
constexpr int kTileH = kT * kLdH;      // bf16 elements per staged tile
constexpr int kTileF = kT * kLdF;      // fp32 elements per staged tile

// Rows [row0, row0 + 64) of a bf16 [*, L, H, 64] tensor as they lie,
// into dst[r * kLdH + d]; rows at or past len read as 0.
__device__ __forceinline__ void stage_h(bf16* dst, const bf16* base, long long sl, int row0,
                                        int len) {
  for (int c = threadIdx.x; c < kT * 8; c += kThreads) {
    const int r = c >> 3, d0 = (c & 7) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < len)
      raw = __ldg(reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * sl + d0));
    *reinterpret_cast<uint4*>(dst + r * kLdH + d0) = raw;
  }
}

// c[n] += A[16 x 64] B for the 64 columns of B, with A's 16 rows at a
// (row-major, pitch kLdH) and B either [k][n] row-major (FragBRow) or
// the transpose of a [n][k] row-major tile (FragBCol).
template <typename FragB>
__device__ __forceinline__ void mma_16x64(FragC (&c)[4], const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragA fa;
    wm::load_matrix_sync(fa, a + 16 * kk, kLdH);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragB fb;
      if constexpr (std::is_same_v<FragB, FragBRow>)
        wm::load_matrix_sync(fb, b + 16 * kk * kLdH + 16 * n, kLdH);
      else
        wm::load_matrix_sync(fb, b + 16 * n * kLdH + 16 * kk, kLdH);
      wm::mma_sync(c[n], fa, fb, c[n]);
    }
  }
}

__device__ __forceinline__ void zero(FragC (&c)[4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) wm::fill_fragment(c[n], 0.f);
}

// The warp's 16 x 64 product into its 16 rows of an fp32 tile.
__device__ __forceinline__ void store_16x64(float* dst, const FragC (&c)[4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) wm::store_matrix_sync(dst + 16 * n, c[n], kLdF, wm::mem_row_major);
}

// The thread's 8 columns (4tx.. and 32+4tx..) of one fp32 tile row.
__device__ __forceinline__ void load_row8(const float* row, float (&x)[8]) {
  const int tx = threadIdx.x & 7;
  const float4 lo = ld4(row + 4 * tx), hi = ld4(row + 32 + 4 * tx);
  x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
  x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

// The same 8 columns of one bf16 tile row, rounded to bf16.
__device__ __forceinline__ void store_row8_h(bf16* row, const float (&x)[8]) {
  const int tx = threadIdx.x & 7;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    row[4 * tx + e] = __float2bfloat16(x[e]);
    row[32 + 4 * tx + e] = __float2bfloat16(x[4 + e]);
  }
}

// The tile column of the thread's e-th value in load_row8's order.
__device__ __forceinline__ int col8(int e) { return 4 * (threadIdx.x & 7) + (e < 4 ? e : 28 + e); }

// ---------------------------------------------------------------------
// K1 in bf16 on Hopper (hopper.cuh): wgmma fed by a TMA ring.  A block
// owns 128 query rows of one (batch, head): two consumer warpgroups of
// 64 rows and a producer warp.  The producer loads the Q tile once and
// then 128-key tiles of K and V into a ring of kFwdStages stages (a
// full mbarrier for K, one for V, an empty one per stage), as 64-row
// boxes of 4-D tensor maps over [B, L, H, D] with the caller's strides,
// so q/k/v sliced from one projection are read in place and rows at or
// past len arrive as zeros.  Each consumer warpgroup computes
//   S = Q Kᵀ   wgmma m64n128k16 x 4 from shared memory (K is K-major),
// then the online softmax on S's accumulator registers: a row's 128
// scores lie in the 4 threads of a quad, so its max takes two shuffles;
// the running sum stays per thread and is summed over the quad once at
// the end.  p is rounded to bf16 pairs in registers, which are the A
// fragments of
//   O += P V   wgmma m64n64k16 x 8 with A from registers (V MN-major),
// and O (32 fp32 a thread) is rescaled in registers.  Neither S, P nor
// O touches shared memory.  Scores are kept in log2 units, t = s scale
// log2(e), and exponentiated by ex2.approx (fast_exp2: the same function
// as expf up to rounding, within phase 1's tolerance); masked scores
// take the finite kNegInf; lse = m ln 2 + log l; out = acc / l by IEEE
// division.  The two warpgroups share each K and V tile and run in step;
// letting them take turns (named barriers) with each issuing S_t beside
// P_{t-1} V_{t-1}, as FlashAttention-3 does, was slower on the H100 in
// a trial (PERF.md).
// ---------------------------------------------------------------------
constexpr int kFwdRows = 128;  // query rows per block
constexpr int kFwdKeys = 128;  // keys per tile
constexpr int kFwdStages = 2;
constexpr int kFwdConsumerWarps = 8;
constexpr int kFwdThreads = 32 * kFwdConsumerWarps + 32;  // + the producer warp
constexpr int kTileBytes = 128 * 64 * 2;                  // 128 rows of D = 64
constexpr int kBox = 64;                                  // rows per TMA box
constexpr int kFwdBytes = (1 + 2 * kFwdStages) * kTileBytes + 8 * (1 + 3 * kFwdStages) + 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the MUFU unit alone: relative error about 2^-22, results below
// 2^-126 flushed to 0 (exp2f adds a range fix-up around it).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct FwdArgs {
  bf16* out;
  float* lse;
  int len, heads, causal;
  float scale_log2;  // scale * log2(e)
};

// Masks (when kMask) and scales one row's 32 scores d[4 j + 2 h + e] of
// this thread, returns their max.
template <bool kMask>
__device__ __forceinline__ float scale_row(float (&s)[64], int h, float c, int row, int col0,
                                           int len, int causal) {
  float mx = kNegInf;
#pragma unroll
  for (int j = 0; j < kFwdKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float& x = s[4 * j + 2 * h + e];
      x *= c;
      if (kMask) {
        const int col = col0 + 8 * j + e;
        if (col >= len || (causal && col > row)) x = kNegInf;
      }
      mx = fmaxf(mx, x);
    }
  }
  return mx;
}

template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&o)[32], float (&m)[2],
                                             float (&l)[2], const int (&row)[2], int col0,
                                             const FwdArgs& a) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = scale_row<kMask>(s, h, a.scale_log2, row[h], col0, a.len, a.causal);
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
    // Key 0 is visible to every row, so m is finite from the first tile
    // on and a masked score weighs exp2(kNegInf - m) = 0.
    const float m_new = fmaxf(m[h], mx);
    const float alpha = fast_exp2(m[h] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kFwdKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = fast_exp2(x - m_new);
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

__global__ void __launch_bounds__(kFwdThreads)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sK = sQ + kTileBytes;                 // [stage]
  unsigned char* sV = sK + kFwdStages * kTileBytes;    // [stage]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kFwdStages * kTileBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kFwdStages;
  uint64_t* empty = v_full + kFwdStages;

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * kFwdRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Key tiles past the block's last row are skipped when causal.
  const int n_keys = a.causal ? min(a.len, q0 + kFwdRows) : a.len;
  const int tiles = (n_keys + kFwdKeys - 1) / kFwdKeys;
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], kFwdConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kFwdConsumerWarps) {  // the producer
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(q_full, kTileBytes);
      for (int r = 0; r < kFwdRows; r += kBox)
        hopper::tma_load_4d(sQ + r * 128, &tq, q_full, 0, q0 + r, h, b);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kFwdStages, k0 = t * kFwdKeys;
        if (t >= kFwdStages) hopper::mbar_wait(&empty[s], (t / kFwdStages - 1) & 1);
        hopper::mbar_arrive_expect_tx(&k_full[s], kTileBytes);
        for (int r = 0; r < kFwdKeys; r += kBox)
          hopper::tma_load_4d(sK + s * kTileBytes + r * 128, &tk, &k_full[s], 0, k0 + r, h, b);
        hopper::mbar_arrive_expect_tx(&v_full[s], kTileBytes);
        for (int r = 0; r < kFwdKeys; r += kBox)
          hopper::tma_load_4d(sV + s * kTileBytes + r * 128, &tv, &v_full[s], 0, k0 + r, h, b);
      }
    }
    return;
  }

  // A consumer warpgroup: rows q0 + 64 wg ...; this thread's two rows.
  const int wg = warp >> 2;
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int row[2] = {r0, r0 + 8};
  const int min_row = q0 + wg * 64;
  const unsigned char* q = sQ + wg * 64 * 128;
  float o[32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  hopper::mbar_wait(q_full, 0);

  for (int t = 0; t < tiles; ++t) {
    const int s = t % kFwdStages, k0 = t * kFwdKeys;
    const uint32_t parity = (t / kFwdStages) & 1;
    const unsigned char* kt = sK + s * kTileBytes;
    const unsigned char* vt = sV + s * kTileBytes;
    float sc[64];
    hopper::mbar_wait(&k_full[s], parity);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n128k16_ss<0>(sc, hopper::desc_sw128(q + 32 * kk, 16, 1024),
                                     hopper::desc_sw128(kt + 32 * kk, 16, 1024), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    const int col0 = k0 + 2 * (lane & 3);
    if (k0 + kFwdKeys > a.len || (a.causal && k0 + kFwdKeys - 1 > min_row))
      softmax_tile<true>(sc, o, m, l, row, col0, a);
    else
      softmax_tile<false>(sc, o, m, l, row, col0, a);

    uint32_t p[32];  // p as bf16 pairs: the A fragments, 4 per 16 keys
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(sc[2 * i], sc[2 * i + 1]);
      p[i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    hopper::mbar_wait(&v_full[s], parity);
    hopper::fence_regs(o);
    hopper::fence_regs(p);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
      const uint32_t frag[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      hopper::wgmma_m64n64k16_rs<1>(o, frag, hopper::desc_sw128(vt + 2048 * kk, 1024, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
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
    if (row[hh] >= a.len) continue;
    const long long r = ((long long)b * a.len + row[hh]) * a.heads + h;
    bf16* dst = a.out + r * 64 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] / l[hh], o[4 * j + 2 * hh + 1] / l[hh]);
    if ((lane & 3) == 0) a.lse[r] = m[hh] * kLn2 + logf(l[hh]);
  }
}

// Writes the warp's 16 rows of an fp32 tile to rows [row0, ...) of an
// fp32 [B, L, H, 64] tensor at dst (offset to its (batch, head)).
__device__ __forceinline__ void write_rows(float* dst, const float* tile, int row0, int len,
                                           long long stride) {
  const int ty = threadIdx.x >> 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (row0 + r >= len) continue;
    float x[8];
    load_row8(tile + r * kLdF, x);
    store_row8<float>(dst + (long long)(row0 + r) * stride, x, 1.f);
  }
}

constexpr int kDqTcBytes = 5 * kTileH * 2 + 2 * kTileF * 4;

// K2a on the tensor cores: s = q kᵀ and dp = g vᵀ per 64-key tile, ds
// by the row's owners, dq += ds k held in WMMA accumulators.
__global__ void __launch_bounds__(kThreads) dq_tc_kernel(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + kTileH;
  bf16* sK = sG + kTileH;
  bf16* sV = sK + kTileH;
  bf16* sDS = sV + kTileH;
  float* sS = reinterpret_cast<float*>(sDS + kTileH);
  float* sDP = sS + kTileF;

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * kT, warp = threadIdx.x >> 5;
  const int ty = threadIdx.x >> 3;
  const long long off = (long long)b * a.sb + (long long)h * a.sh;
  const long long head = ((long long)b * a.len * a.heads + h) * 64;
  const long long sg = (long long)a.heads * 64;
  const bf16* q = static_cast<const bf16*>(a.q) + off;
  const bf16* k = static_cast<const bf16*>(a.k) + off;
  const bf16* v = static_cast<const bf16*>(a.v) + off;
  stage_h(sQ, q, a.sl, q0, a.len);
  stage_h(sG, static_cast<const bf16*>(a.g) + head, sg, q0, a.len);

  float lse[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const long long r = ((long long)b * a.len + row) * a.heads + h;
    lse[i] = row < a.len ? a.lse[r] : 0.f;
    delta[i] = row < a.len ? a.delta[r] : 0.f;
  }
  FragC dq[4];
  zero(dq);

  const int n_keys = a.causal ? min(a.len, q0 + kT) : a.len;
  for (int k0 = 0; k0 < n_keys; k0 += kT) {
    __syncthreads();
    stage_h(sK, k, a.sl, k0, a.len);
    stage_h(sV, v, a.sl, k0, a.len);
    __syncthreads();
    FragC c[4];
    zero(c);
    mma_16x64<FragBCol>(c, sQ + 16 * warp * kLdH, sK);
    store_16x64(sS + 16 * warp * kLdF, c);
    zero(c);
    mma_16x64<FragBCol>(c, sG + 16 * warp * kLdH, sV);
    store_16x64(sDP + 16 * warp * kLdF, c);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, row = q0 + r;
      float s[8], dp[8];
      load_row8(sS + r * kLdF, s);
      load_row8(sDP + r * kLdF, dp);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = k0 + col8(e);
        const float x = (col >= a.len || (a.causal && col > row)) ? kNegInf : s[e] * a.scale;
        s[e] = expf(x - lse[i]) * (dp[e] - delta[i]) * a.scale;
      }
      store_row8_h(sDS + r * kLdH, s);
    }
    __syncwarp();
    mma_16x64<FragBRow>(dq, sDS + 16 * warp * kLdH, sK);
  }
  store_16x64(sS + 16 * warp * kLdF, dq);
  __syncwarp();
  write_rows(a.dq + head, sS, q0, a.len, sg);
}

constexpr int kDkvTcBytes = 6 * kTileH * 2 + 2 * kTileF * 4 + 2 * kT * 4;

// K2b on the tensor cores.  Warp w owns keys kb0 + 16w..16w+15: sᵀ = k
// qᵀ and dpᵀ = v gᵀ per 64-row tile, pᵀ and dsᵀ by the keys' owners,
// dv += pᵀ g and dk += dsᵀ q held in WMMA accumulators.
__global__ void __launch_bounds__(kThreads) dkv_tc_kernel(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTileH;
  bf16* sQ = sV + kTileH;
  bf16* sG = sQ + kTileH;
  bf16* sP = sG + kTileH;   // pᵀ: [key][row]
  bf16* sDS = sP + kTileH;  // dsᵀ: [key][row]
  float* sS = reinterpret_cast<float*>(sDS + kTileH);
  float* sDP = sS + kTileF;
  float* sLse = sDP + kTileF;
  float* sDelta = sLse + kT;

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int kb0 = blockIdx.x * kT, warp = threadIdx.x >> 5;
  const int ty = threadIdx.x >> 3;
  const long long off = (long long)b * a.sb + (long long)h * a.sh;
  const long long head = ((long long)b * a.len * a.heads + h) * 64;
  const long long sg = (long long)a.heads * 64;
  const bf16* q = static_cast<const bf16*>(a.q) + off;
  const bf16* g = static_cast<const bf16*>(a.g) + head;
  stage_h(sK, static_cast<const bf16*>(a.k) + off, a.sl, kb0, a.len);
  stage_h(sV, static_cast<const bf16*>(a.v) + off, a.sl, kb0, a.len);
  FragC dk[4], dv[4];
  zero(dk);
  zero(dv);

  for (int q0 = a.causal ? kb0 : 0; q0 < a.len; q0 += kT) {
    __syncthreads();
    stage_h(sQ, q, a.sl, q0, a.len);
    stage_h(sG, g, sg, q0, a.len);
    if (threadIdx.x < kT) {
      const int row = q0 + threadIdx.x;
      const long long r = ((long long)b * a.len + row) * a.heads + h;
      sLse[threadIdx.x] = row < a.len ? a.lse[r] : 0.f;
      sDelta[threadIdx.x] = row < a.len ? a.delta[r] : 0.f;
    }
    __syncthreads();
    FragC c[4];
    zero(c);
    mma_16x64<FragBCol>(c, sK + 16 * warp * kLdH, sQ);
    store_16x64(sS + 16 * warp * kLdF, c);
    zero(c);
    mma_16x64<FragBCol>(c, sV + 16 * warp * kLdH, sG);
    store_16x64(sDP + 16 * warp * kLdF, c);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      float s[8], dp[8];
      load_row8(sS + r * kLdF, s);
      load_row8(sDP + r * kLdF, dp);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = col8(e), row = q0 + j;
        const float x = masked(row, kb0 + r, a.len, a.causal) ? kNegInf : s[e] * a.scale;
        s[e] = expf(x - sLse[j]);
        dp[e] = s[e] * (dp[e] - sDelta[j]) * a.scale;
      }
      store_row8_h(sP + r * kLdH, s);
      store_row8_h(sDS + r * kLdH, dp);
    }
    __syncwarp();
    mma_16x64<FragBRow>(dv, sP + 16 * warp * kLdH, sG);
    mma_16x64<FragBRow>(dk, sDS + 16 * warp * kLdH, sQ);
  }
  store_16x64(sS + 16 * warp * kLdF, dk);
  store_16x64(sDP + 16 * warp * kLdF, dv);
  __syncwarp();
  write_rows(a.dk + head, sS, kb0, a.len, sg);
  write_rows(a.dv + head, sDP, kb0, a.len, sg);
}

enum Which { kFwd, kDq, kDkv };

// K1 in bf16: a tensor map per operand over [B, L, H, 64] with the
// shared strides, boxes of 64 rows; the grid of 128-row blocks.
int launch_fwd_wgmma(const AttnArgs& a, cudaStream_t stream) {
  static bool configured[hopper::kMaxDevices] = {};
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(a.len),
                              static_cast<cuuint64_t>(a.heads),
                              static_cast<cuuint64_t>(a.batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(a.sl) * 2,
                                 static_cast<cuuint64_t>(a.sh) * 2,
                                 static_cast<cuuint64_t>(a.sb) * 2};
  const cuuint32_t box[4] = {64, kBox, 1, 1};
  CUtensorMap tq, tk, tv;
  if (!hopper::encode_bf16(&tq, a.q, dims, strides, box) ||
      !hopper::encode_bf16(&tk, a.k, dims, strides, box) ||
      !hopper::encode_bf16(&tv, a.v, dims, strides, box))
    return hopper::kEncodeFailed;
  const int rc = hopper::allow_smem(fwd_wgmma_kernel, kFwdBytes, configured);
  if (rc) return rc;
  const FwdArgs f{static_cast<bf16*>(a.out), a.lse, a.len, a.heads, a.causal,
                  a.scale * kLog2e};
  fwd_wgmma_kernel<<<dim3((a.len + kFwdRows - 1) / kFwdRows, a.batch * a.heads), kFwdThreads,
                     kFwdBytes, stream>>>(tq, tk, tv, f);
  return static_cast<int>(cudaGetLastError());
}

// Launches K1, K2a or K2b: the tensor-core kernels for bf16, the FMA
// kernels for fp32.
template <Which kWhich>
struct LaunchAttention {
  AttnArgs a;
  cudaStream_t stream;

  template <typename K>
  int launch(K kernel, int tile, int bytes, bool (&configured)[hopper::kMaxDevices]) const {
    if (bytes > 48 * 1024) {
      const int rc = hopper::allow_smem(kernel, bytes, configured);
      if (rc) return rc;
    }
    kernel<<<dim3((a.len + tile - 1) / tile, a.batch * a.heads), kThreads, bytes, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }

  template <typename T, int D>
  int operator()() const {
    static bool configured[hopper::kMaxDevices] = {};
    constexpr bool kTc = std::is_same_v<T, bf16>;
    if constexpr (kTc && kWhich == kFwd) {
      return launch_fwd_wgmma(a, stream);
    } else if constexpr (kTc && kWhich == kDq) {
      return launch(dq_tc_kernel, kT, kDqTcBytes, configured);
    } else if constexpr (kTc) {
      return launch(dkv_tc_kernel, kT, kDkvTcBytes, configured);
    } else if constexpr (kWhich == kFwd) {
      return launch(fwd_kernel, kBQ, 0, configured);
    } else if constexpr (kWhich == kDq) {
      return launch(dq_kernel, kBQ, kDqSmemFloats * 4, configured);
    } else {
      return launch(dkv_kernel, kBKV, kDkvSmemFloats * 4, configured);
    }
  }
};

}  // namespace
}  // namespace adt

// Each entry point returns 0, a cudaError_t, or -1 for an unsupported
// (dtype, head_dim).  q, k, v share the strides (sb, sl, sh), in
// elements; every other tensor is contiguous.

// K1: out [B, L, H, D] in the input dtype, lse [B, L, H] fp32.
extern "C" int adt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       long long sb, long long sl, long long sh, void* out,
                                       float* lse, int batch, int len, int heads, int head_dim,
                                       int dtype, float scale, int causal, void* stream) {
  adt::AttnArgs a{q,       k,       v,       sb,      sl,    sh,  nullptr, out,   lse,
                  nullptr, nullptr, nullptr, nullptr, batch, len, heads,   scale, causal};
  return adt::dispatch(dtype, head_dim,
                       adt::LaunchAttention<adt::kFwd>{a, static_cast<cudaStream_t>(stream)});
}

// K2a: dq [B, L, H, D] fp32.
extern "C" int adt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          long long sb, long long sl, long long sh,
                                          const void* g, const float* lse, const float* delta,
                                          float* dq, int batch, int len, int heads,
                                          int head_dim, int dtype, float scale, int causal,
                                          void* stream) {
  adt::AttnArgs a{q,  k,       v,       sb,    sl,  sh,    g,     nullptr, const_cast<float*>(lse),
                  delta, dq, nullptr, nullptr, batch, len, heads, scale, causal};
  return adt::dispatch(dtype, head_dim,
                       adt::LaunchAttention<adt::kDq>{a, static_cast<cudaStream_t>(stream)});
}

// K2b: dk, dv [B, L, H, D] fp32.
extern "C" int adt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           long long sb, long long sl, long long sh,
                                           const void* g, const float* lse, const float* delta,
                                           float* dk, float* dv, int batch, int len, int heads,
                                           int head_dim, int dtype, float scale, int causal,
                                           void* stream) {
  adt::AttnArgs a{q,     k,       v,  sb, sl,    sh,  g,     nullptr, const_cast<float*>(lse),
                  delta, nullptr, dk, dv, batch, len, heads, scale,   causal};
  return adt::dispatch(dtype, head_dim,
                       adt::LaunchAttention<adt::kDkv>{a, static_cast<cudaStream_t>(stream)});
}
