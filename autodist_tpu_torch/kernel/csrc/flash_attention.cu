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
// * bf16: Hopper's wgmma fed by TMA rings (hopper.cuh), with every
//   score, probability and accumulator tile in registers: K1
//   (fwd_wgmma_kernel), K2a (dq_wgmma_kernel) and K2b (dkv_wgmma_kernel),
//   see their sections.
#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace adt {
namespace {

constexpr int kD = 64;         // head dim (BERT-base: 768 / 12)
constexpr int kThreads = 128;  // 16 row groups (ty) x 8 column groups (tx)
constexpr int kBQ = 64;        // fp32 K1, K2a: query rows per block
constexpr int kBK = 32;        // fp32 K1, K2a: keys per tile
constexpr int kBKV = 64;       // fp32 K2b: keys per block
constexpr int kBQ2 = 32;       // fp32 K2b: query rows per tile
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

using bf16 = __nv_bfloat16;

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
constexpr float kLn2 = 0.6931471805599453f;
using hopper::fast_exp2;
using hopper::kLog2e;
using hopper::pack_bf16;

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
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
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

// ---------------------------------------------------------------------
// K2a and K2b in bf16 on Hopper, the same machinery as K1: a block of
// one consumer warpgroup (64 rows for K2a, 64 keys for K2b) and a
// producer warp that keeps a ring of kBwdStages stages full with TMA
// loads of 64-row boxes (4-D tensor maps over [B, L, H, D]: q/k/v with
// the caller's strides, g contiguous; rows at or past len arrive as
// zeros), a full and an empty mbarrier per stage.  Every product is a
// wgmma m64n64k16 with fp32 accumulators in registers; the softmax work
// runs on those registers, and p and ds are rounded to bf16 pairs there,
// which are the A fragments of the register (RS) form of the next
// product.  Neither S, dP, P nor dS touches shared memory.  Scores are
// in log2 units, p = exp2(s scale log2(e) - lse log2(e)) by ex2.approx
// as in K1, ds = p (dp - delta) scale, with masked scores at kNegInf;
// rows and keys at or past len and the causal triangle are masked
// explicitly, not left to the zero fill.
//
// K2a (dq): Q and g once, 64-key tiles of K and V through the ring; per
// tile S = Q Kᵀ and dP = g Vᵀ (both operands K-major), dS in registers,
// dQ += dS K (K read MN-major with the transpose bit, as K1 reads V).
// Each thread keeps its two rows' lse and delta in registers.
// K2b (dk, dv): K and V resident; 64-row tiles of Q and g, with their
// lse (times log2(e)) and delta, through the ring; per tile the
// transposed products Sᵀ = K Qᵀ and dPᵀ = V gᵀ, Pᵀ and dSᵀ in registers
// (lse and delta vary along the columns), then dV += Pᵀ g and dK += dSᵀ
// Q with g and Q read MN-major: the same swizzled Q tile is read K-major
// for Sᵀ and MN-major for dK.  The producer's 32 lanes load lse and
// delta (4 H bytes apart, no TMA box) into the stage and arrive on its
// full barrier beside the TMA bytes.
//
// One warpgroup a block, so that several blocks share an SM (K2a three,
// at most 128 registers a thread; K2b two, at most 168): they wait on
// their own rings and drift apart, one's exponentials and epilogue
// running under another's products.  On the H100, blocks of two
// warpgroups in step (one block an SM) were slower, and so was
// exponentiating under the second score product (K2b then spills);
// PERF.md has the times.  Two kernels as in the JAX package, no atomics:
// dq, dk and dv are summed in one fixed order, so every run gives the
// same bits.
// The epilogue stages the fp32 accumulators through the freed ring (rows
// padded to 72 floats) and writes whole 256-byte rows in coalesced
// 16-byte stores.
// ---------------------------------------------------------------------
constexpr int kBwdStages = 3;
constexpr int kBwdThreads = 128 + 32;  // a consumer warpgroup and the producer warp
constexpr int kBoxBytes = kBox * 128;  // one 64-row box of D = 64
constexpr int kStatArrivals = 1 + 32;  // K2b's full: the TMA bytes and each producer lane
constexpr int kEpiPitch = 72;          // fp32 row pitch of the epilogue's staging
constexpr int kEpiBytes = 64 * kEpiPitch * 4;
// The ring: two resident boxes (K2a: Q and g; K2b: K and V), then per
// stage two (K2a: K and V; K2b: Q and g); K2b adds per stage 64 lse and
// 64 delta.  The epilogue stages one (K2a) or two (K2b) fp32 tiles in it.
constexpr int kBwdRing = 2 * kBoxBytes + 2 * kBwdStages * kBoxBytes;
constexpr int kBwdBarriers = 8 * (1 + 2 * kBwdStages);
constexpr int kDqBytes = kBwdRing + kBwdBarriers + 1024;
constexpr int kDkvBytes = kBwdRing + kBwdStages * 2 * 64 * 4 + kBwdBarriers + 1024;
static_assert(2 * kEpiBytes <= kBwdRing, "the epilogue stages its tiles in the freed ring");

struct BwdArgs {
  const float* lse;    // [B, L, H]
  const float* delta;  // [B, L, H]
  float* d0;           // dq (K2a) or dk (K2b), [B, L, H, D] fp32
  float* d1;           // dv (K2b)
  int len, heads, causal;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// Writes the warpgroup's 64 x 64 fp32 accumulator to rows row0.. of an
// fp32 [*, L, H, 64] tensor at dst (row stride `stride` floats; rows at
// or past len left out) through `stage`: the accumulator layout goes in
// as 8-byte pairs, and each row goes out as 16 coalesced 16-byte stores.
__device__ __forceinline__ void store_tile(float* stage, const float (&acc)[32], float* dst,
                                           int row0, int len, long long stride) {
  const int t = threadIdx.x, lane = t & 31;
  const int r = 16 * (t >> 5) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(stage + (r + 8 * hh) * kEpiPitch + 8 * j + 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  hopper::bar_sync(1, 128);
#pragma unroll
  for (int c = t; c < 64 * 16; c += 128) {
    const int row = c >> 4, col = 4 * (c & 15);
    if (row0 + row < len)
      *reinterpret_cast<float4*>(dst + (long long)(row0 + row) * stride + col) =
          *reinterpret_cast<const float4*>(stage + row * kEpiPitch + col);
  }
}

// K2a's dS for one 64-key tile on the accumulators of S and dP (this
// thread's rows row[0..1], keys col0 + 8 j + e), packed to A fragments.
template <bool kMask>
__device__ __forceinline__ void dq_tile_ds(const float (&s)[32], const float (&dp)[32],
                                           uint32_t (&ds)[16], const float (&lse2)[2],
                                           const float (&delta)[2], const int (&row)[2],
                                           int col0, const BwdArgs& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hh + e;
        float x = fmaf(s[i], a.scale_log2, -lse2[hh]);
        if (kMask && masked(row[hh], col0 + 8 * j + e, a.len, a.causal)) x = kNegInf;
        v[e] = fast_exp2(x) * (dp[i] - delta[hh]) * a.scale;
      }
      ds[2 * j + hh] = pack_bf16(v[0], v[1]);
    }
  }
}

__global__ void __launch_bounds__(kBwdThreads, 3)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                    BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sG = sQ + kBoxBytes;
  unsigned char* sK = sG + kBoxBytes;                // [stage]
  unsigned char* sV = sK + kBwdStages * kBoxBytes;   // [stage]
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(smem + kBwdRing);
  uint64_t* full = qg_full + 1;
  uint64_t* empty = full + kBwdStages;

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * kBox;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Key tiles past the block's last row are skipped when causal.
  const int n_keys = a.causal ? min(a.len, q0 + kBox) : a.len;
  const int tiles = (n_keys + kBox - 1) / kBox;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qg_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(qg_full, 2 * kBoxBytes);
      hopper::tma_load_4d(sQ, &tq, qg_full, 0, q0, h, b);
      hopper::tma_load_4d(sG, &tg, qg_full, 0, q0, h, b);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kBwdStages;
        if (t >= kBwdStages) hopper::mbar_wait(&empty[s], (t / kBwdStages - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * kBoxBytes);
        hopper::tma_load_4d(sK + s * kBoxBytes, &tk, &full[s], 0, t * kBox, h, b);
        hopper::tma_load_4d(sV + s * kBoxBytes, &tv, &full[s], 0, t * kBox, h, b);
      }
    }
    return;
  }

  // The consumer warpgroup: this thread's two rows.
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const int row[2] = {r0, r0 + 8};
  float lse2[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long r = ((long long)b * a.len + row[hh]) * a.heads + h;
    lse2[hh] = row[hh] < a.len ? a.lse[r] * kLog2e : 0.f;
    delta[hh] = row[hh] < a.len ? a.delta[r] : 0.f;
  }
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  hopper::mbar_wait(qg_full, 0);

  for (int t = 0; t < tiles; ++t) {
    const int s = t % kBwdStages, k0 = t * kBox;
    const unsigned char* kt = sK + s * kBoxBytes;
    const unsigned char* vt = sV + s * kBoxBytes;
    hopper::mbar_wait(&full[s], (t / kBwdStages) & 1);
    float sc[32], dp[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n64k16_ss(sc, hopper::desc_sw128(sQ + 32 * kk, 16, 1024),
                                 hopper::desc_sw128(kt + 32 * kk, 16, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n64k16_ss(dp, hopper::desc_sw128(sG + 32 * kk, 16, 1024),
                                 hopper::desc_sw128(vt + 32 * kk, 16, 1024), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    uint32_t ds[16];
    const int col0 = k0 + 2 * (lane & 3);
    if (q0 + kBox > a.len || k0 + kBox > a.len || (a.causal && k0 + kBox - 1 > q0))
      dq_tile_ds<true>(sc, dp, ds, lse2, delta, row, col0, a);
    else
      dq_tile_ds<false>(sc, dp, ds, lse2, delta, row, col0, a);
    hopper::fence_regs(dq);
    hopper::fence_regs(ds);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t frag[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3]};
      hopper::wgmma_m64n64k16_rs<1>(dq, frag, hopper::desc_sw128(kt + 2048 * kk, 1024, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  hopper::bar_sync(1, 128);  // every wgmma has read the ring
  const long long head = ((long long)b * a.len * a.heads + h) * 64;
  store_tile(reinterpret_cast<float*>(smem), dq, a.d0 + head, q0, a.len, (long long)a.heads * 64);
}

// K2b's Pᵀ and dSᵀ for one 64-row tile on the accumulators of Sᵀ and
// dPᵀ (this thread's keys key[0..1], rows q0 + c + 8 j + e with lse2
// and delta from the stage), packed to A fragments.
template <bool kMask>
__device__ __forceinline__ void dkv_tile_p_ds(const float (&st)[32], const float (&dpt)[32],
                                              uint32_t (&p)[16], uint32_t (&ds)[16],
                                              const float* lse2, const float* delta,
                                              const int (&key)[2], int q0, int c,
                                              const BwdArgs& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + c);
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + c);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float pv[2], dsv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hh + e;
        float x = fmaf(st[i], a.scale_log2, -(e ? l2.y : l2.x));
        if (kMask && masked(q0 + c + 8 * j + e, key[hh], a.len, a.causal)) x = kNegInf;
        pv[e] = fast_exp2(x);
        dsv[e] = pv[e] * (dpt[i] - (e ? dl.y : dl.x)) * a.scale;
      }
      p[2 * j + hh] = pack_bf16(pv[0], pv[1]);
      ds[2 * j + hh] = pack_bf16(dsv[0], dsv[1]);
    }
  }
}

__global__ void __launch_bounds__(kBwdThreads, 2)
    dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                     BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = sK + kBoxBytes;
  unsigned char* sQ = sV + kBoxBytes;                // [stage]
  unsigned char* sG = sQ + kBwdStages * kBoxBytes;   // [stage]
  float* sLse = reinterpret_cast<float*>(smem + kBwdRing);  // [stage][64], log2 units
  float* sDelta = sLse + kBwdStages * 64;                   // [stage][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDelta + kBwdStages * 64);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kBwdStages;

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int kb0 = blockIdx.x * kBox;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Query tiles wholly above the block's keys are skipped when causal.
  const int qstart = a.causal ? kb0 : 0;
  const int tiles = (a.len - qstart + kBox - 1) / kBox;
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      hopper::mbar_init(&full[s], kStatArrivals);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * kBoxBytes);
      hopper::tma_load_4d(sK, &tk, kv_full, 0, kb0, h, b);
      hopper::tma_load_4d(sV, &tv, kv_full, 0, kb0, h, b);
    }
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kBwdStages, q0 = qstart + t * kBox;
      if (t >= kBwdStages) hopper::mbar_wait(&empty[s], (t / kBwdStages - 1) & 1);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[s], 2 * kBoxBytes);
        hopper::tma_load_4d(sQ + s * kBoxBytes, &tq, &full[s], 0, q0, h, b);
        hopper::tma_load_4d(sG + s * kBoxBytes, &tg, &full[s], 0, q0, h, b);
      }
      for (int i = lane; i < kBox; i += 32) {
        const int row = q0 + i;
        const long long r = ((long long)b * a.len + row) * a.heads + h;
        sLse[s * kBox + i] = row < a.len ? a.lse[r] * kLog2e : 0.f;
        sDelta[s * kBox + i] = row < a.len ? a.delta[r] : 0.f;
      }
      hopper::mbar_arrive(&full[s]);  // after this lane's stores
    }
    return;
  }

  // The consumer warpgroup: this thread's two keys.
  const int k_0 = kb0 + warp * 16 + (lane >> 2);
  const int key[2] = {k_0, k_0 + 8};
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  hopper::mbar_wait(kv_full, 0);

  for (int t = 0; t < tiles; ++t) {
    const int s = t % kBwdStages, q0 = qstart + t * kBox;
    const unsigned char* q = sQ + s * kBoxBytes;
    const unsigned char* g = sG + s * kBoxBytes;
    hopper::mbar_wait(&full[s], (t / kBwdStages) & 1);
    float st[32], dpt[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n64k16_ss(st, hopper::desc_sw128(sK + 32 * kk, 16, 1024),
                                 hopper::desc_sw128(q + 32 * kk, 16, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n64k16_ss(dpt, hopper::desc_sw128(sV + 32 * kk, 16, 1024),
                                 hopper::desc_sw128(g + 32 * kk, 16, 1024), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    uint32_t p[16], ds[16];
    const int c = 2 * (lane & 3);
    const float* lse2 = sLse + s * kBox;
    const float* delta = sDelta + s * kBox;
    if (kb0 + kBox > a.len || q0 + kBox > a.len || (a.causal && kb0 + kBox - 1 > q0))
      dkv_tile_p_ds<true>(st, dpt, p, ds, lse2, delta, key, q0, c, a);
    else
      dkv_tile_p_ds<false>(st, dpt, p, ds, lse2, delta, key, q0, c, a);
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    hopper::fence_regs(p);
    hopper::fence_regs(ds);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t frag[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      hopper::wgmma_m64n64k16_rs<1>(dv, frag, hopper::desc_sw128(g + 2048 * kk, 1024, 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t frag[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3]};
      hopper::wgmma_m64n64k16_rs<1>(dk, frag, hopper::desc_sw128(q + 2048 * kk, 1024, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  hopper::bar_sync(1, 128);  // every wgmma has read the ring
  const long long head = ((long long)b * a.len * a.heads + h) * 64;
  float* stage = reinterpret_cast<float*>(smem);
  store_tile(stage, dk, a.d0 + head, kb0, a.len, (long long)a.heads * 64);
  store_tile(stage + kEpiBytes / 4, dv, a.d1 + head, kb0, a.len, (long long)a.heads * 64);
}

enum Which { kFwd, kDq, kDkv };

// A bf16 tensor map over a [B, L, H, 64] operand with (batch, length,
// head) strides sb, sl, sh in elements: boxes of 64 rows of one head.
bool encode_rows(CUtensorMap* map, const void* base, const AttnArgs& a, long long sb,
                 long long sl, long long sh) {
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(a.len),
                              static_cast<cuuint64_t>(a.heads),
                              static_cast<cuuint64_t>(a.batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, kBox, 1, 1};
  return hopper::encode_bf16(map, base, dims, strides, box);
}

// K1 in bf16: a tensor map per operand; the grid of 128-row blocks.
int launch_fwd_wgmma(const AttnArgs& a, cudaStream_t stream) {
  static bool configured[hopper::kMaxDevices] = {};
  CUtensorMap tq, tk, tv;
  if (!encode_rows(&tq, a.q, a, a.sb, a.sl, a.sh) || !encode_rows(&tk, a.k, a, a.sb, a.sl, a.sh) ||
      !encode_rows(&tv, a.v, a, a.sb, a.sl, a.sh))
    return hopper::kEncodeFailed;
  const int rc = hopper::allow_smem(fwd_wgmma_kernel, kFwdBytes, configured);
  if (rc) return rc;
  const FwdArgs f{static_cast<bf16*>(a.out), a.lse, a.len, a.heads, a.causal,
                  a.scale * kLog2e};
  fwd_wgmma_kernel<<<dim3((a.len + kFwdRows - 1) / kFwdRows, a.batch * a.heads), kFwdThreads,
                     kFwdBytes, stream>>>(tq, tk, tv, f);
  return static_cast<int>(cudaGetLastError());
}

// K2a or K2b in bf16: tensor maps over q, k, v (shared strides) and the
// contiguous g; the grid of 64-row (K2a) or 64-key (K2b) blocks.
template <typename K>
int launch_bwd_wgmma(K kernel, int bytes, const AttnArgs& a, cudaStream_t stream,
                     bool (&configured)[hopper::kMaxDevices]) {
  const long long sl_g = (long long)a.heads * 64;
  CUtensorMap tq, tk, tv, tg;
  if (!encode_rows(&tq, a.q, a, a.sb, a.sl, a.sh) || !encode_rows(&tk, a.k, a, a.sb, a.sl, a.sh) ||
      !encode_rows(&tv, a.v, a, a.sb, a.sl, a.sh) ||
      !encode_rows(&tg, a.g, a, sl_g * a.len, sl_g, 64))
    return hopper::kEncodeFailed;
  const int rc = hopper::allow_smem(kernel, bytes, configured);
  if (rc) return rc;
  const BwdArgs f{a.lse,   a.delta,  a.dq != nullptr ? a.dq : a.dk, a.dv, a.len, a.heads,
                  a.causal, a.scale, a.scale * kLog2e};
  kernel<<<dim3((a.len + kBox - 1) / kBox, a.batch * a.heads), kBwdThreads, bytes, stream>>>(
      tq, tk, tv, tg, f);
  return static_cast<int>(cudaGetLastError());
}

// Launches K1, K2a or K2b: the wgmma kernels for bf16, the FMA kernels
// for fp32.
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
      return launch_bwd_wgmma(dq_wgmma_kernel, kDqBytes, a, stream, configured);
    } else if constexpr (kTc) {
      return launch_bwd_wgmma(dkv_wgmma_kernel, kDkvBytes, a, stream, configured);
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
