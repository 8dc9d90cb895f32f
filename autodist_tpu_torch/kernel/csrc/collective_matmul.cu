// One step of the collective-matmul ring (K4): out = carry + x @ k,
// accumulated in fp32 and rounded once to the carry's type.
//
// Replaces: autodist_tpu/kernel/pallas/collective_matmul.py,
// _matmul_acc_kernel.  The Pallas kernel holds the whole [M, K] x [K, C]
// problem in VMEM and lets the MXU stream it; here each block owns a
// tile of the output, loops over K in steps staged through shared
// memory, and adds the carry in its epilogue, so the partial product
// never goes to device memory and back (the composed ring's separate
// add).
//
// x is [M, K] and carry/out [M, C], contiguous; k is [K, C] with row
// stride ldk, so the ring's chunk of a wider kernel (a column slice) is
// read where it lies.  M, K and C that are not tile multiples are masked
// in the loads (zeros) and the stores, not padded by copies.  Rows that
// do not start 16-byte aligned take an element-wise load instead of the
// asynchronous copies.
//
// Two designs, one per type:
// * bf16 on the tensor cores: a 128 x 128 tile per block of 8 warps,
//   each warp 64 x 32 of it as 4 x 2 WMMA 16x16x16 fragments with fp32
//   accumulators; the k loop keeps the next 32-deep tile of x and k in
//   flight (cp.async into the second of two shared-memory stages, 37 KB)
//   while the warps multiply the current one; the epilogue takes each
//   fragment through shared memory, adds f32(carry) and rounds to bf16
//   once;
// * fp32 on the CUDA cores in plain FMAs (no TF32, so the CPU goldens'
//   full fp32 precision holds): 256 threads, each a 4 x 4 block of the
//   tile, the x tile staged transposed so one 16-byte read gives 4 rows.
//
// Bound on this card: at the main path's shapes (bf16, M = 4096, K =
// 512 or 2048, C = 512) a call does 2 M K C flops against (M K + K C +
// 2 M C) * 2 bytes: 256 to 410 flops per byte, at or above the H100's
// ridge of about 295, so operations bound it (2.2 to 8.7 us at 989
// TFLOP/s).  WMMA (mma.sync) reaches a fraction of that; wgmma with a
// TMA ring and warp specialization is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "attention_common.cuh"

namespace adt {
namespace {

// ------------------------------------------------------------------ //
// bf16: WMMA, with the next k-tile in flight
// ------------------------------------------------------------------ //
constexpr int kTcBM = 128;
constexpr int kTcBN = 128;
constexpr int kBK = 32;
constexpr int kTcThreads = 256;  // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int kLdA = kBK + 8;    // bf16 pitches: multiples of 8 elements
constexpr int kLdB = kTcBN + 8;
constexpr int kStageA = kTcBM * kLdA;  // elements per stage
constexpr int kStageB = kBK * kLdB;
constexpr int kTcSmem = 2 * (kStageA + kStageB) * 2;  // two stages, bytes

// 16 bytes global -> shared without staging through registers; the
// bytes past src_bytes (0 to 16) are written as zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// One [128 x 32] tile of x and one [32 x 128] tile of k into a stage,
// two 8-element vectors of each per thread.  kVec: rows start 16-byte
// aligned (the wrapper's check), so each vector is one cp.async with
// the ragged tail zero-filled; otherwise element by element.
template <bool kVec>
__device__ __forceinline__ void load_stage(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                           const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ k, int M, int K,
                                           int C, long long ldk, int m0, int n0, int k0) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int idx = threadIdx.x + t * kTcThreads;
    {  // x: 128 rows x 4 vectors
      const int r = idx >> 2, c = (idx & 3) * 8;
      const int gr = m0 + r, gc = k0 + c;
      __nv_bfloat16* dst = As + r * kLdA + c;
      if (kVec) {
        const int n = gr < M ? max(0, min(8, K - gc)) : 0;
        cp_async16(dst, n ? x + (long long)gr * K + gc : x, 2 * n);
      } else {
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < M && gc + e < K) ? x[(long long)gr * K + gc + e] : zero;
      }
    }
    {  // k: 32 rows x 16 vectors
      const int r = idx >> 4, c = (idx & 15) * 8;
      const int gk = k0 + r, gc = n0 + c;
      __nv_bfloat16* dst = Bs + r * kLdB + c;
      if (kVec) {
        const int n = gk < K ? max(0, min(8, C - gc)) : 0;
        cp_async16(dst, n ? k + (long long)gk * ldk + gc : k, 2 * n);
      } else {
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < K && gc + e < C) ? k[(long long)gk * ldk + gc + e] : zero;
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kTcThreads)
    matmul_acc_tc_kernel(const __nv_bfloat16* __restrict__ carry,
                         const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ k, __nv_bfloat16* __restrict__ out,
                         int M, int K, int C, long long ldk) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kTcSmem];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + 2 * kStageA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int tiles = (K + kBK - 1) / kBK;
  load_stage<kVec>(As, Bs, x, k, M, K, C, ldk, m0, n0, 0);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < tiles)  // the other stage was last read in step t - 1
      load_stage<kVec>(As + (cur ^ 1) * kStageA, Bs + (cur ^ 1) * kStageB, x, k, M, K, C,
                       ldk, m0, n0, (t + 1) * kBK);
    cp_async_commit();
    cp_async_wait_prev();  // every group but the newest: tile t is in
    __syncthreads();
    const __nv_bfloat16* A = As + cur * kStageA;
    const __nv_bfloat16* B = Bs + cur * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], A + (wm * 64 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], B + kk * kLdB + wn * 32 + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // Epilogue, one 16 x 16 fragment at a time through this warp's 1 KB of
  // the (now idle) stage memory: add f32(carry), round once to bf16.
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = m0 + wm * 64 + i * 16 + (e >> 4);
        const int gc = n0 + wn * 32 + j * 16 + (e & 15);
        if (gr < M && gc < C) {
          const long long o = (long long)gr * C + gc;
          out[o] = __float2bfloat16(__fadd_rn(__bfloat162float(carry[o]), scratch[e]));
        }
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------------ //
// fp32: CUDA-core FMAs
// ------------------------------------------------------------------ //
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK32 = 16;
constexpr int kThreads32 = 256;   // 16 row groups (ty) x 16 column groups (tx)

__global__ void __launch_bounds__(kThreads32)
    matmul_acc_f32_kernel(const float* __restrict__ carry, const float* __restrict__ x,
                          const float* __restrict__ k, float* __restrict__ out, int M, int K,
                          int C, long long ldk) {
  __shared__ __align__(16) float As[kBK32 * kBM];   // transposed: As[c * kBM + r]
  __shared__ __align__(16) float Bs[kBK32 * kBN];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK32) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int idx = tid + t * kThreads32;
      const int r = idx >> 4, c = idx & 15;             // x tile [64 x 16]
      const int gr = m0 + r, gc = k0 + c;
      As[c * kBM + r] = (gr < M && gc < K) ? x[(long long)gr * K + gc] : 0.f;
      const int rb = idx >> 6, cb = idx & 63;           // k tile [16 x 64]
      const int gk = k0 + rb, gn = n0 + cb;
      Bs[rb * kBN + cb] = (gk < K && gn < C) ? k[(long long)gk * ldk + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(As + kk * kBM + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(Bs + kk * kBN + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = m0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + tx * 4 + j;
      if (gc < C) {
        const long long o = (long long)gr * C + gc;
        out[o] = __fadd_rn(carry[o], acc[i][j]);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace
}  // namespace adt

// out [M, C] = carry [M, C] + x [M, K] @ k [K, C] (row stride ldk), all
// of one type (dtype code 0 fp32, 1 bf16).  Returns -1 for another type,
// else a cudaError_t (0 on success).
extern "C" int adt_matmul_acc(const void* carry, const void* x, const void* k, void* out,
                              int M, int K, int C, long long ldk, int dtype, void* stream) {
  using namespace adt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || C == 0) return 0;
  if (dtype == kBF16) {
    const dim3 grid((C + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM);
    const auto* c16 = static_cast<const __nv_bfloat16*>(carry);
    const auto* x16 = static_cast<const __nv_bfloat16*>(x);
    const auto* k16 = static_cast<const __nv_bfloat16*>(k);
    auto* o16 = static_cast<__nv_bfloat16*>(out);
    if (aligned16(x) && K % 8 == 0 && aligned16(k) && ldk % 8 == 0)
      matmul_acc_tc_kernel<true><<<grid, kTcThreads, 0, s>>>(c16, x16, k16, o16, M, K, C, ldk);
    else
      matmul_acc_tc_kernel<false><<<grid, kTcThreads, 0, s>>>(c16, x16, k16, o16, M, K, C, ldk);
  } else if (dtype == kF32) {
    const dim3 grid((C + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    matmul_acc_f32_kernel<<<grid, kThreads32, 0, s>>>(
        static_cast<const float*>(carry), static_cast<const float*>(x),
        static_cast<const float*>(k), static_cast<float*>(out), M, K, C, ldk);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
