// One step of the collective-matmul ring (K4): out = carry + x @ k,
// accumulated in fp32 and rounded once to the carry's type.
//
// Replaces: autodist_tpu/kernel/pallas/collective_matmul.py,
// _matmul_acc_kernel.  The Pallas kernel holds the whole [M, K] x [K, C]
// problem in VMEM and lets the MXU stream it; here each block owns a
// tile of the output, streams K through shared memory, and adds the
// carry in its epilogue, so the partial product never goes to device
// memory and back (the composed ring's separate add).
//
// x is [M, K] and carry/out [M, C], contiguous; k is [K, C] with row
// stride ldk, so the ring's chunk of a wider kernel (a column slice) is
// read where it lies.
//
// Two designs, one per type:
// * bf16 on Hopper's tensor cores (hopper.cuh): a 128 x 128 output tile
//   per block of two consumer warpgroups (64 rows each, one wgmma
//   m64n128k16 per 16-deep step, fp32 accumulators in registers) and
//   one producer warp that keeps a ring of kStages 64-deep k-tiles in
//   flight with TMA, each stage guarded by a full and an empty mbarrier.
//   x's tile is K-major; k's is read in place MN-major (the transpose
//   bit), as boxes of 64 columns x 64 k-rows.  TMA zero-fills rows and
//   columns past M, K and C, so the ragged edge needs no masked loads.
//   The epilogue reads carry and writes out straight from the
//   accumulator registers, as bf16 pairs (single elements when C is
//   odd), adds in fp32 and rounds once.  TMA needs 16-byte aligned rows:
//   the wrapper stages an operand that is not so (a zero-padded copy) and
//   counts it, so this entry point only sees operands it can describe;
// * fp32 on the CUDA cores in plain FMAs (no TF32, so the CPU goldens'
//   full fp32 precision holds): 256 threads, each a 4 x 4 block of the
//   tile, the x tile staged transposed so one 16-byte read gives 4 rows.
//
// Bound on this card: at the main path's shapes (bf16, M = 4096, K =
// 512 or 2048, C = 512) a call does 2 M K C flops against (M K + K C +
// 2 M C) * 2 bytes: 256 to 410 flops per byte, at or above the H100's
// ridge of about 295, so operations bound it (2.2 to 8.7 us at 989
// TFLOP/s), the carry and out bytes weighing most at K = 512.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace adt {
namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

// ------------------------------------------------------------------ //
// bf16: wgmma fed by a TMA ring
// ------------------------------------------------------------------ //
constexpr int kTcBM = 128;     // two consumer warpgroups of 64 rows
// 128 columns: one wave of 128 blocks at the main path's
// [4096, *] @ [*, 512], one block an SM; 64-wide tiles (two waves) were
// slower at K = 2048 (PERF.md).
constexpr int kTcBN = 128;
constexpr int kTcBK = 64;      // one 128-byte swizzle row of bf16
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;
constexpr int kTcThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr int kBoxBytes = 64 * 64 * 2;                // one 64 x 64 bf16 box

constexpr int kA = kTcBM * kTcBK * 2;   // x: 128 rows x 64
constexpr int kB = kTcBK * kTcBN * 2;   // k: two boxes of 64 x 64
constexpr int kStage = kA + kB;
constexpr int kTcSmem = kStages * kStage + 2 * kStages * 8 + 1024;

__device__ __forceinline__ void mma_ktile(float (&acc)[kTcBN / 2], const unsigned char* a,
                                          const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < kTcBK / 16; ++kk)
    wgmma_m64n128k16_ss<1>(acc, desc_sw128(a + 32 * kk, 16, 1024),
                           desc_sw128(b + 2048 * kk, kBoxBytes, 1024), 1);
}

// kPairs: C is even and carry/out 4-byte aligned, so the epilogue moves
// bf16 pairs.
template <bool kPairs>
__global__ void __launch_bounds__(kTcThreads)
    matmul_acc_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tk, const bf16* __restrict__ carry,
                         bf16* __restrict__ out, int M, int K, int C) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  const int tiles = (K + kTcBK - 1) / kTcBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
        unsigned char* a = smem + s * kStage;
        mbar_arrive_expect_tx(&full[s], kStage);
        tma_load_2d(a, &tx, &full[s], t * kTcBK, m0);
#pragma unroll
        for (int j = 0; j < kTcBN / 64; ++j)
          tma_load_2d(a + kA + j * kBoxBytes, &tk, &full[s], n0 + 64 * j, t * kTcBK);
      }
    }
    return;
  }

  // A consumer warpgroup: rows m0 + 64 wg ...
  const int wg = warp >> 2;
  float acc[kTcBN / 2];
#pragma unroll
  for (int i = 0; i < kTcBN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    const unsigned char* a = smem + s * kStage;
    fence_regs(acc);
    wgmma_fence();
    mma_ktile(acc, a + wg * 64 * 128, a + kA);
    wgmma_commit();
    wgmma_wait<1>();  // the previous k-tile's products are done
    fence_regs(acc);
    if (t > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(t - 1) % kStages]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue from the accumulators: f32(carry) + acc, one rounding.
  const int row0 = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kTcBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const long long o = (long long)row * C + col;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (kPairs) {
        if (col < C) {
          const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(carry + o));
          *reinterpret_cast<__nv_bfloat162*>(out + o) =
              __floats2bfloat162_rn(__fadd_rn(c.x, v0), __fadd_rn(c.y, v1));
        }
      } else {
        if (col < C) out[o] = __float2bfloat16(__fadd_rn(__bfloat162float(carry[o]), v0));
        if (col + 1 < C)
          out[o + 1] = __float2bfloat16(__fadd_rn(__bfloat162float(carry[o + 1]), v1));
      }
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

bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3) == 0; }

template <bool kPairs>
int launch_tc(const CUtensorMap& tx, const CUtensorMap& tk, const bf16* carry, bf16* out, int M,
              int K, int C, cudaStream_t s) {
  static bool configured[kMaxDevices] = {};
  auto kernel = matmul_acc_wgmma_kernel<kPairs>;
  const int rc = allow_smem(kernel, kTcSmem, configured);
  if (rc) return rc;
  const dim3 grid((C + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM);
  kernel<<<grid, kTcThreads, kTcSmem, s>>>(tx, tk, carry, out, M, K, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace adt

// out [M, C] = carry [M, C] + x [M, K] @ k [K, C] (row stride ldk), all
// of one type (dtype code 0 fp32, 1 bf16).  Returns -1 for another type,
// -2 when a bf16 operand cannot be described as a tensor map (x and k
// must start 16-byte aligned, with K and ldk multiples of 8), else a
// cudaError_t (0 on success).
extern "C" int adt_matmul_acc(const void* carry, const void* x, const void* k, void* out,
                              int M, int K, int C, long long ldk, int dtype, void* stream) {
  using namespace adt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || C == 0) return 0;
  if (dtype == kBF16) {
    CUtensorMap tx, tk;
    const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
    const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(K) * 2};
    const cuuint32_t x_box[2] = {kTcBK, kTcBM};
    const cuuint64_t k_dims[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(K)};
    const cuuint64_t k_strides[1] = {static_cast<cuuint64_t>(ldk) * 2};
    const cuuint32_t k_box[2] = {64, kTcBK};
    if (!hopper::encode_bf16(&tx, x, x_dims, x_strides, x_box) ||
        !hopper::encode_bf16(&tk, k, k_dims, k_strides, k_box))
      return hopper::kEncodeFailed;
    const auto* c16 = static_cast<const bf16*>(carry);
    auto* o16 = static_cast<bf16*>(out);
    if (C % 2 == 0 && aligned4(carry) && aligned4(out))
      return launch_tc<true>(tx, tk, c16, o16, M, K, C, s);
    return launch_tc<false>(tx, tk, c16, o16, M, K, C, s);
  }
  if (dtype == kF32) {
    const dim3 grid((C + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    matmul_acc_f32_kernel<<<grid, kThreads32, 0, s>>>(
        static_cast<const float*>(carry), static_cast<const float*>(x),
        static_cast<const float*>(k), static_cast<float*>(out), M, K, C, ldk);
    return static_cast<int>(cudaGetLastError());
  }
  return -1;
}
