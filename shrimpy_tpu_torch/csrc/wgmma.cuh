// Warpgroup matrix multiply (wgmma.mma_async, sm_90a only) from operands in
// shared memory, for kernels that run tensor-core products on this card:
// the swizzled layout operands are written in, the shared-memory descriptor
// that names such an operand, the fence, commit and wait around a group of
// products, and the m64nN products (N 32 or 64) of bf16 (k16) and TF32 (k8)
// operands into float32 accumulators held in registers.
//
// Layout (K-major, 128-byte swizzle, the canonical layout of both operands):
// an operand tile of `rows` rows (M of A, N of B) holds K in blocks of 128
// bytes (64 bf16 or 32 TF32 values). Block kb is `rows` rows of 128 bytes,
// row r at kb * rows * 128 + r * 128; in each 8-row group of 1024 bytes, the
// 16-byte piece p of row r sits at piece p ^ (r % 8). The tile starts on a
// 1024-byte boundary. A product of depth 32 bytes (k16 bf16, k8 TF32) reads
// the tile through a descriptor that starts 32 * s bytes into block s / 4.
// TF32 operands must be K-major (the transpose bits are for 16-bit types
// only), so a (k, n) row-major B is written transposed.
//
// Accumulators: thread t of the warpgroup (warp w = t / 32, lane l) holds
// d[4 j + 2 h + e] = D[16 w + l / 4 + 8 h][8 j + 2 (l % 4) + e], j < N / 8.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Byte offset of element (r, kk) in a K-major 128-byte-swizzled tile of
// `rows` rows of E-byte elements.
template <int E>
__device__ __forceinline__ unsigned sw128_offset(int r, int kk, int rows) {
  constexpr int kPerBlock = 128 / E;
  const int kb = kk / kPerBlock, byte = (kk % kPerBlock) * E;
  return (unsigned)(kb * rows * 128 + r * 128 + ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15));
}

// The descriptor of a K-major 128-byte-swizzled operand whose product reads
// from shared address `addr`: start address >> 4, leading byte offset 16
// (unused for this layout), stride byte offset 1024 (the next 8-row group),
// layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Orders this warpgroup's register and shared-memory writes before the
// products that follow (after the proxy fence that publishes shared memory
// written by threads).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// a fence or wait.
template <int R>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SHRIMPY_WGMMA_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
#define SHRIMPY_WGMMA_OPERANDS32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define SHRIMPY_WGMMA_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
#define SHRIMPY_WGMMA_OPERANDS64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
  "+f"(d[31])
// d += A B for a 64 x 16 bf16 A and a 16 x N bf16 B, both K-major.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SHRIMPY_WGMMA_D32
               "%16, %17, p, 1, 1, 0, 0;\n}\n"
               : SHRIMPY_WGMMA_OPERANDS32(d)
               : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SHRIMPY_WGMMA_D64
               "%32, %33, p, 1, 1, 0, 0;\n}\n"
               : SHRIMPY_WGMMA_OPERANDS64(d)
               : "l"(a), "l"(b), "r"(1));
}

// d += A B for a 64 x 8 TF32 A and a 8 x N TF32 B, both K-major.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " SHRIMPY_WGMMA_D32
               "%16, %17, p, 1, 1;\n}\n"
               : SHRIMPY_WGMMA_OPERANDS32(d)
               : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SHRIMPY_WGMMA_D64
               "%32, %33, p, 1, 1;\n}\n"
               : SHRIMPY_WGMMA_OPERANDS64(d)
               : "l"(a), "l"(b), "r"(1));
}

}  // namespace
