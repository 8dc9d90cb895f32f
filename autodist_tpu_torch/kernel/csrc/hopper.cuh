// Hopper (sm_90a) building blocks shared by the bf16 kernels K1, K2a
// and K2b (flash_attention.cu), K4 (collective_matmul.cu) and K7
// (flash_prefill.cu): TMA tensor maps and bulk tensor loads, mbarrier
// rings, named barriers, wgmma on 128-byte-swizzled shared-memory tiles,
// and the exp2 and bf16 packing of the softmax on its accumulators.
//
// Tensor maps are encoded on the host by cuTensorMapEncodeTiled, found
// through the runtime's cudaGetDriverEntryPoint (so the library links no
// -lcuda and build.py's flags stay as they are), on every call in the C
// entry point (a few microseconds of host time), and passed to the
// kernel by value as `const __grid_constant__ CUtensorMap`.
//
// A 128B-swizzled tile holds rows of 64 bf16 (128 bytes); TMA writes
// row r at byte 128 r with its eight 16-byte chunks permuted by r % 8,
// so a tile starts on a 1024-byte boundary and every group of 8 rows is
// one 1024-byte swizzle atom.  wgmma reads such tiles through a 64-bit
// descriptor (desc_sw128):
//   * K-major operand (the reduction dim contiguous, a row of 64): rows
//     8-row groups apart are SBO = 1024 bytes apart; LBO is unused
//     (16); the k16 step kk of a 64-deep tile starts 32 kk bytes in.
//   * MN-major operand (the M or N dim contiguous, a tile row is one
//     step of the reduction dim), read with the transpose bit: SBO =
//     1024 is the stride between groups of 8 reduction steps, LBO the
//     stride between 64-wide atoms along N; the k16 step kk starts 2048
//     kk bytes in.
//
// Accumulator layout of wgmma m64nNk16 (fp32): thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 and that row + 8, and
// columns 8 j + 2 (t % 4) and + 1 for j < N / 8, in d[4 j + 0, 1] (the
// row) and d[4 j + 2, 3] (the row + 8).  The A fragment of the register
// (RS) form holds the same positions of a 64 x 16 tile as bf16 pairs:
// a[0] = (row, 2 (t % 4) + 0, 1), a[1] = row + 8, a[2] = columns + 8,
// a[3] = both; so d of a product over 16 columns 16 kk.. packs to the
// A fragment of step kk as pairs (d[8 kk + 2 i], d[8 kk + 2 i + 1]).
#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace adt {
namespace hopper {

// Returned by a C entry point when cuTensorMapEncodeTiled refused to
// describe an operand as a tensor map (alignment or stride); the Python
// wrappers stage such operands first, so this is a bug, not a fallback.
constexpr int kEncodeFailed = -2;
constexpr int kMaxDevices = 64;
// An mbarrier wait that has not completed after this long traps, so a
// ring that lost a phase ends the process's CUDA context (a sticky
// error that the next synchronize reports) instead of hanging it.  Far
// above any wait on a card that two processes share and preempt.
constexpr unsigned long long kWaitLimitNs = 30000000000ull;

// ------------------------------------------------------------------ //
// host: tensor maps and the shared-memory limit
// ------------------------------------------------------------------ //
inline PFN_cuTensorMapEncodeTiled encode_tiled() {
  static const PFN_cuTensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map of rank R over base: dims and box innermost first,
// the byte strides of dims 1..R-1; 128-byte swizzle, zeros out of
// bounds.  False if cuTensorMapEncodeTiled refuses it.
template <int R>
bool encode_bf16(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[R],
                 const cuuint64_t (&strides)[R - 1], const cuuint32_t (&box)[R]) {
  const PFN_cuTensorMapEncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint32_t unit[R];
  for (int i = 0; i < R; ++i) unit[i] = 1;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, R, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raises a kernel's dynamic shared-memory limit once per device.
template <typename K>
int allow_smem(K kernel, int bytes, bool (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) configured[dev] = true;
  }
  return 0;
}

// ------------------------------------------------------------------ //
// device: shared memory, mbarriers, TMA
// ------------------------------------------------------------------ //
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (swizzled tiles start on
// one; the kernels ask for 1024 bytes more than they use).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// After the barriers' init, before any other thread uses them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA writes in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` has completed (the barrier
// starts in phase 0; its n-th completion ends phase n - 1).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}

// Orders this thread's generic-proxy writes to shared memory before
// later async-proxy reads of it (wgmma operands, TMA): after the
// writes, before the barrier that hands the tile to the wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `count` threads, a
// multiple of 32: syncs a subset of the block's warps.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// TMA: the box at coordinates (c0, c1[, c2, c3]) (innermost first) of
// map into shared memory at dst, completing `bytes` on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ------------------------------------------------------------------ //
// device: the softmax on wgmma accumulators
// ------------------------------------------------------------------ //
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the MUFU unit alone: relative error about 2^-22, results below
// 2^-126 flushed to 0 (exp2f adds a range fix-up around it).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to a bf16 pair: one 32-bit register of an A
// fragment of the register (RS) form of wgmma.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// ------------------------------------------------------------------ //
// device: wgmma
// ------------------------------------------------------------------ //
// Descriptor of a 128B-swizzled tile starting at `tile` (see the top).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// Before a wgmma that reads registers (accumulators, A fragments) that
// ordinary instructions wrote, and before the first one.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins register values at this point of the instruction stream: the
// compiler may not move their reads or writes across it (around a
// wgmma's issue and its wait, which it does not otherwise see use them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// bf16 wgmma with fp32 accumulators: d = A B + (scale_d ? d : 0), the
// m64nNk16 tile of a warpgroup; kTransB = 1 reads B MN-major.
// d[64] (+)= A[64 x 16] B[16 x 128], A and B from shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB));
}

// d[32] (+)= A[64 x 16] B[16 x 64], both from shared memory, both
// K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[32] (+)= A[64 x 16] B[16 x 64], A from registers (a[4], bf16 pairs),
// B from shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
}

}  // namespace hopper
}  // namespace adt
