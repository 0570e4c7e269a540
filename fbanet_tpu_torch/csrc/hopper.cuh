// Hopper (sm_90a) building blocks in PTX: mbarriers, 2-D TMA tile loads,
// shared-memory matrix descriptors and warpgroup matrix products (wgmma)
// with bf16 operands in shared memory and f32 accumulators in registers.
//
// Operand layouts, all in 128-byte swizzle atoms: 64 bf16 columns x `rows`
// rows, 128 bytes per row, the 16-byte chunks of row r XOR-ed with r % 8
// (what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B and a 64-column box
// writes). An atom starts on a 1024-byte boundary; atoms of one operand lie
// `atom_stride` bytes apart.
//  - "MN-major" (mn_major_desc, transpose bit 1): the M or N index is the
//    one along the 128-byte row, as a [tokens, columns] row-major tile
//    lands there; rows run along K, so a k16 step is +16 rows = +2048
//    bytes, and the leading byte offset is the atom stride (R1's A and B,
//    K4's W1 chunk in dy = dz1 W1 and its dz1^T tile).
//  - "K-major" (k_major_desc, transpose bit 0): K runs along the 128-byte
//    row and rows are M or N (K4's LayerNorm output y and gradient g as A,
//    its W1 and W2^T chunks as B of z1 = y W1^T and dh2 = g W2). A k16 step
//    is +32 bytes inside the atom's row (the hardware applies the swizzle
//    to the address it forms), every 4th step moves to the next atom; 8
//    rows are 1024 bytes apart (the stride byte offset), and a 64-row M
//    block starts 8192 bytes further on.
// Shared memory that threads write and wgmma or TMA then read is handed
// over with fence_proxy_async() before the barrier that orders them.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cudaTypedefs.h>

#include <cstdint>

namespace fbanet {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// arrive once and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one 2-D box of `map` at (inner, outer) into shared memory; completion
// counts its bytes on `bar`. Rows past the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int inner,
                                            int outer, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(inner), "r"(outer)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// wgmma descriptor of an MN-major operand in 128-byte swizzle atoms at
// shared address `addr` (1024-byte aligned phase): `atom_stride` bytes
// between 64-column atoms (the leading byte offset), 1024 bytes between
// groups of 8 token rows (the stride byte offset).
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr, uint32_t atom_stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((atom_stride >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma descriptor of a K-major operand in 128-byte swizzle atoms at
// shared address `addr` (inside a 1024-byte aligned atom, plus 32 bytes per
// k16 step): 1024 bytes between groups of 8 rows; the leading byte offset
// is unused for a swizzled K-major operand (1 by convention).
__device__ __forceinline__ uint64_t k_major_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// order this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[64 x N] += A[64 x 16] B[16 x N], A and B bf16 MN-major in shared memory
// (descriptors `da`, `db`), d f32 in the warpgroup's registers: thread t
// holds d[4j + 2h + e] = D[16 (t / 32) + (t % 32) / 4 + 8 h][8 j + 2 (t % 4) + e].
__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

template <int N> __device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma widths instantiated here");
  if constexpr (N == 64)
    wgmma_m64n64(d, da, db);
  else
    wgmma_m64n128(d, da, db);
}

// d[64 x 32] += A[64 x 16] B[16 x 32] with A and B bf16 K-major in shared
// memory (transpose bits 0), d f32 in registers as for wgmma_m64n64: thread
// t holds d[4j + 2h + e] = D[16 (t / 32) + (t % 32) / 4 + 8 h][8 j + 2 (t % 4) + e].
__device__ __forceinline__ void wgmma_kk_m64n32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// Host: a [rows, cols] row-major bf16 tensor in global memory as TMA boxes
// of 64 columns x `box_rows` rows, 128-byte swizzled (the atoms above);
// rows past the end read as zeros. cuTensorMapEncodeTiled is looked up
// once through the CUDA runtime (no link against libcuda).
inline cudaError_t make_tma_map_bf16(CUtensorMap* map, const void* ptr, int rows, int cols,
                                     int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn)
               : nullptr;
  }();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace fbanet
