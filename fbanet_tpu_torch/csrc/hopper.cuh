// Hopper (sm_90a) building blocks in PTX: mbarriers, 2-D TMA tile loads,
// shared-memory matrix descriptors and warpgroup matrix products (wgmma)
// with bf16 operands in shared memory (A also in registers) and f32
// accumulators in registers, and the device helpers the wgmma forms of K2,
// K3 and K4 share.
//
// Operand layouts in 128-byte swizzle atoms (tiles of 32- and 64-byte rows
// further below): 64 bf16 columns x `rows`
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

#include "common.cuh"

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

// one 3-D box of `map` at (c0, c1, c2), as tma_load_2d
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// descriptor layout types: 128-, 64- and 32-byte swizzle
enum : uint64_t { kSw128 = 1, kSw64 = 2, kSw32 = 3 };

// wgmma descriptor: start address, leading and stride byte offsets, layout
// type. K-major: sbo = 8 rows of the tile (8 pitch), lbo unused (16);
// MN-major: sbo = 8 rows along K, lbo = the stride between MN atoms.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// wgmma descriptor of an MN-major operand in 128-byte swizzle atoms at
// shared address `addr` (1024-byte aligned phase): `atom_stride` bytes
// between 64-column atoms (the leading byte offset), 1024 bytes between
// groups of 8 token rows (the stride byte offset).
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr, uint32_t atom_stride) {
  return smem_desc(addr, atom_stride, 1024, kSw128);
}

// wgmma descriptor of a K-major operand in 128-byte swizzle atoms at
// shared address `addr` (inside a 1024-byte aligned atom, plus 32 bytes per
// k16 step): 1024 bytes between groups of 8 rows; the leading byte offset
// is unused for a swizzled K-major operand (1 by convention).
__device__ __forceinline__ uint64_t k_major_desc(uint32_t addr) {
  return smem_desc(addr, 16, 1024, kSw128);
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
// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---- tiles of other pitches, named barriers, products ----
//
// A swizzled tile whose rows are `pitch` = 32, 64 or 128 bytes (16, 32 or
// 64 bf16 columns) has the 16-byte chunks of byte offset o XOR-ed with
// (o >> 7) masked to pitch / 16 - 1 (CuTe's Swizzle<1|2|3, 4, 3>): the
// 128-byte atoms above are the case pitch = 128. K3 keeps each head of
// head size dh in a tile of pitch 2 dh, so each head is a K-major (K = its
// columns) and an MN-major (N = its columns) operand of its own; the
// descriptor's stride byte offset is 8 pitch, and its layout type names
// the pitch (sw_layout).

__host__ __device__ constexpr uint64_t sw_layout(int pitch) {
  return pitch == 128 ? kSw128 : pitch == 64 ? kSw64 : kSw32;
}

// byte offset of (row, byte `col`) in a swizzled tile of `pitch`-byte rows
__device__ __forceinline__ uint32_t swz_at(int row, int col, int pitch) {
  const uint32_t o = (uint32_t)(row * pitch + col);
  return o ^ (((o >> 7) & (uint32_t)(pitch / 16 - 1)) << 4);
}

// wgmma descriptor of a K-major operand in a swizzled tile of `pitch`-byte
// rows (k_major_desc at pitch 128): 8 pitch bytes between groups of 8 rows
__device__ __forceinline__ uint64_t k_desc_at(uint32_t addr, int pitch) {
  return smem_desc(addr, 16, 8 * pitch, sw_layout(pitch));
}

// wgmma descriptor of an MN-major operand in a swizzled tile of `pitch`-
// byte rows along MN: 8 pitch bytes between groups of 8 rows along K, a
// k16 step 16 pitch bytes on, `atom_stride` between the tiles along MN
// (mn_major_desc at pitch 128)
__device__ __forceinline__ uint64_t mn_desc_at(uint32_t addr, uint32_t atom_stride, int pitch) {
  return smem_desc(addr, atom_stride, 8 * pitch, sw_layout(pitch));
}

// barrier `id` (1..15) among the `count` threads of one or more warps
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// d[64 x N] += A[64 x 16] B[16 x N], bf16 operands in shared memory
// (descriptors `da`, `db`), f32 d in the warpgroup's registers: thread t
// holds d[4j + 2h + e] = D[16 (t / 32) + (t % 32) / 4 + 8 h][8 j + 2 (t % 4) + e].
// TA / TB: 0 K-major, 1 MN-major (the transpose bits).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma widths instantiated here");
  if constexpr (N == 16)
    wgmma_ss_n16<TA, TB>(d, da, db);
  else if constexpr (N == 32)
    wgmma_ss_n32<TA, TB>(d, da, db);
  else if constexpr (N == 64)
    wgmma_ss_n64<TA, TB>(d, da, db);
  else
    wgmma_ss_n128<TA, TB>(d, da, db);
}

// The same with A in registers: thread t of the warpgroup holds rows
// r = 16 (t / 32) + (t % 32) / 4 and r + 8, columns c = 2 (t % 4), c + 1
// and c + 8, c + 9 as a[0] = A[r][c..c+1], a[1] = A[r+8][c..c+1], a[2] =
// A[r][c+8..c+9], a[3] = A[r+8][c+8..c+9] (bf16 pairs). That is the
// accumulator's layout: columns 16 k .. 16 k + 15 of a 64-wide f32
// accumulator d become a k16 A operand as pairs (d[8k + 2i], d[8k + 2i + 1]),
// i = 0..3.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma widths instantiated here");
  if constexpr (N == 16)
    wgmma_rs_n16<TB>(d, a, db);
  else if constexpr (N == 32)
    wgmma_rs_n32<TB>(d, a, db);
  else if constexpr (N == 64)
    wgmma_rs_n64<TB>(d, a, db);
  else
    wgmma_rs_n128<TB>(d, a, db);
}

// ---- helpers of the wgmma forms (K2, K3, K4) ----

// gelu_tanh(x) and gelu_tanh_grad(x) (common.cuh) from one tanh, with the
// two functions' own expressions
__device__ __forceinline__ void gelu_and_grad(float x, float* gl, float* dg) {
  const float k = 0.7978845608028654f;
  const float t = tanhf(k * (x + 0.044715f * (x * x * x)));
  const float cdf = 0.5f * (1.0f + t);
  *gl = x * cdf;
  *dg = cdf + x * (0.5f * (1.0f - t * t)) * (k * (1.0f + 3.0f * 0.044715f * (x * x)));
}

// byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a swizzle atom
__device__ __forceinline__ uint32_t swz(int row, int chunk) { return swz_at(row, 16 * chunk, 128); }

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

__device__ __forceinline__ void unpack_bf8(const uint4& u, float v[8]) {
  const float2 a = unpack_bf2(u.x), b = unpack_bf2(u.y), c = unpack_bf2(u.z),
               d = unpack_bf2(u.w);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y, v[4] = c.x, v[5] = c.y, v[6] = d.x,
  v[7] = d.y;
}

// LayerNorm statistics of one token whose C channels lie 8 per lane over a
// segment of `seg` = C / 8 lanes (a fixed xor tree inside the segment); the
// whole warp calls it together
__device__ __forceinline__ void ln_stats8(const float v[8], int seg, int C, float* mu,
                                          float* inv) {
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s += v[i];
    sq += v[i] * v[i];
  }
  for (int o = seg / 2; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  *mu = s / C;
  *inv = rsqrtf(fmaxf(0.f, sq / C - *mu * *mu) + kLnEps);
}

// out(c, s) with s[v] = sum over the tile's n tokens t of f(t, c)[v], for
// c < C (C divides the block's NT threads): thread (c, k) adds tokens
// [k n / K, (k + 1) n / K) in order (K = NT / C), then the K partials add
// in order of k through `red` (NV K C floats). A fixed order: the sums
// repeat bitwise. Every thread of the block calls it.
template <int NT, int NV, typename F, typename Out>
__device__ __forceinline__ void tile_column_sums(int C, int n, float* red, F f, Out out) {
  const int K = NT / C, c = threadIdx.x % C, k = threadIdx.x / C;
  float s[NV] = {};
  for (int t = k * n / K; t < (k + 1) * n / K; ++t) {
    float v[NV];
    f(t, c, v);
#pragma unroll
    for (int j = 0; j < NV; ++j) s[j] += v[j];
  }
  if (K > 1) {
#pragma unroll
    for (int j = 0; j < NV; ++j) red[(k * NV + j) * C + c] = s[j];
  }
  __syncthreads();
  if (k == 0) {
    if (K > 1) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float acc = red[j * C + c];
        for (int kk = 1; kk < K; ++kk) acc += red[(kk * NV + j) * C + c];
        s[j] = acc;
      }
    }
    out(c, s);
  }
  __syncthreads();
}


// Host: cuTensorMapEncodeTiled, looked up once through the CUDA runtime (no
// link against libcuda), or null.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
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
  return encode;
}

// Host: a row-major bf16 tensor of `rank` dimensions (dims and boxes
// innermost first, strides in bytes of dimensions 1..) as swizzled TMA
// boxes (128-byte swizzle, or `swizzle`); elements past the tensor's end
// read as zeros.
inline cudaError_t encode_tma_map_bf16(CUtensorMap* map, const void* ptr, int rank,
                                       const cuuint64_t* dims, const cuuint64_t* strides,
                                       const cuuint32_t* box,
                                       CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Host: a [rows, cols] row-major bf16 tensor in global memory as TMA boxes
// of 64 columns x `box_rows` rows, 128-byte swizzled (the atoms above), or
// with box_cols = 32 as boxes of 32 columns, 64-byte swizzled (tiles of
// 64-byte rows, as the wgmma forms hold C = 32); rows past the end read as
// zeros.
inline cudaError_t make_tma_map_bf16(CUtensorMap* map, const void* ptr, int rows, int cols,
                                     int box_rows, int box_cols = 64) {
  if (box_cols != 64 && box_cols != 32) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return encode_tma_map_bf16(map, ptr, 2, dims, strides, box,
                             box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : CU_TENSOR_MAP_SWIZZLE_64B);
}

// Host: the same tensor (rows a multiple of 8) with each group of 8 rows
// followed by 8 zero rows, as boxes of 64 columns x 32 rows: the 3-D view
// [rows / 8][8][cols] in boxes of 2 groups x 16 rows x 64 columns, whose
// rows 8..15 of each group lie past the middle dimension's end and arrive
// as TMA's zero fill. The box at (column, 0, g) holds tensor rows 8 g ..
// 8 g + 7, 8 zero rows, rows 8 g + 8 .. 8 g + 15, 8 zero rows: a B operand
// with K over rows against A tiles whose heads of 8 are zero-padded to 16
// columns, one k16 step a head.
inline cudaError_t make_tma_map_bf16_pad8(CUtensorMap* map, const void* ptr, int rows,
                                          int cols) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, 8, (cuuint64_t)rows / 8};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)cols * 16};
  const cuuint32_t box[3] = {64, 16, 2};
  return encode_tma_map_bf16(map, ptr, 3, dims, strides, box);
}

}  // namespace fbanet
