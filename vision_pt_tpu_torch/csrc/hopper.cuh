// Hopper building blocks shared by the redesigned kernels (the short
// attention backward, short_attention_bwd.cu; the NF4 dequant-matmul,
// nf4_matmul.cu): asynchronous copies into shared memory (cp.async, 16, 8
// or 4 bytes, zero-filled past an edge) with their groups, the 128-byte
// swizzled tile layout that wgmma reads, its shared-memory matrix
// descriptors, and the warpgroup products (wgmma.mma_async) of 16-bit
// operands with fp32 accumulators.
//
// Tiles. A (R, D) tile of 16-bit values (D 64 or 128) is stored as D / 64
// panels of R rows x 128 bytes; the 16-byte chunk c of row r sits at chunk
// (c ^ (r % 8)) of its row (the 128-byte swizzle, Swizzle<3,4,3>). Every
// tile starts 1024-byte aligned. Such a tile is read by wgmma either
// K-major (rows are M or N, the 64 columns of a panel are K: a q k^T
// operand) or MN-major (rows are K, columns are N: the B of a p v product),
// so one copy of a K, V, Q or dO tile serves both kinds of product.
//
// Descriptors (PTX ISA, "matrix descriptor"; the canonical layouts as CUTLASS
// names them): start address >> 4 in bits 0-13, leading byte offset >> 4 in
// 16-29, stride byte offset >> 4 in 32-45, layout 1 (128-byte swizzle) in
// 62-63. K-major: the stride offset steps 8 rows (1024 bytes), the leading
// offset is unused (1); a k16 step moves the start 32 bytes along the
// panel. MN-major: the stride offset steps 8 K rows (1024 bytes), the
// leading offset steps 64 columns (the next panel); a k16 step moves the
// start 16 rows.
//
// Register operands. The accumulator of a m64nN product holds, in warp w of
// the warpgroup, rows 16w + g and 16w + g + 8 (g = lane / 4, t = lane % 4):
// d[4j + e] is row 16w + g + 8 (e / 2), column 8j + 2t + e % 2, the mma.sync
// C layout for each 8 columns. An A operand in registers has the mma.sync
// m16n8k16 A layout per warp, so the accumulator of one product, rounded to
// 16 bits in pairs, is the A of the next (pack_a below).

#pragma once

#include "attention_common.cuh"

namespace vpt {

// ----------------------------------------------------------------- cp.async

// 16 bytes global -> shared; zeros when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// make this thread's completed shared-memory writes visible to wgmma (the
// async proxy); a barrier after it publishes them to the warpgroup
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------ swizzled 16-bit tiles

// byte offset of 16-byte chunk c (of D / 8) of row r in an R-row tile
template <int R>
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// rows [r0, r0 + R) of a (S, D) head slice with row stride `stride`
// (elements) -> an R-row swizzled tile at `dst`, by cp.async of all
// `threads` threads; rows at or past `limit` are zeros
template <int R, int D, typename T>
__device__ __forceinline__ void cp_async_tile(unsigned char* dst, const T* src,
                                              long long stride, int r0,
                                              int limit, int threads) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < R * CH; i += threads) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < limit;
    cp_async16(dst + sw128<R>(r, c), ok ? src + (r0 + r) * stride + c * 8 : src,
               ok);
  }
}

__device__ __forceinline__ uint64_t smem_desc(const void* smem, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((addr >> 4) & 0x3FFFu) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | ((uint64_t)1 << 62);
}

// K-major operand: all rows of an R-row tile, k16 step kk
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor(const unsigned char* tile,
                                                int kk) {
  return smem_desc(tile + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16, 1024);
}

// MN-major operand (rows are K): k16 step kk of an R-row tile, all columns
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(const unsigned char* tile,
                                                 int kk) {
  return smem_desc(tile + kk * 16 * 128, R * 128, 1024);
}

// --------------------------------------------------------------- warpgroup

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator (or of A
// registers) across the fence and the asynchronous products that use it:
// pinned before wgmma_fence and after wgmma_wait
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void pin(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e]) :: "memory");
}

// the A operand (16 rows x 16 columns a warp) of k16 step kc from columns
// [16kc, 16kc + 16) of an accumulator, rounded to T
template <typename T, int R>
__device__ __forceinline__ void pack_a(uint32_t a[4], const float (&d)[R],
                                       int kc) {
  a[0] = pack2<T>(d[8 * kc + 0], d[8 * kc + 1]);
  a[1] = pack2<T>(d[8 * kc + 2], d[8 * kc + 3]);
  a[2] = pack2<T>(d[8 * kc + 4], d[8 * kc + 5]);
  a[3] = pack2<T>(d[8 * kc + 6], d[8 * kc + 7]);
}

// wgmma.mma_async m64nNk16, fp32 accumulators d (N / 2 a thread):
//   wgmma_ss: d (+)= A B^T, A (64 x 16) and B (N x 16) K-major in shared
//             memory; N 32 or 64 (the s and dp of 32- or 64-key tiles)
//   wgmma_rs: d (+)= A B, A in registers, B (16 x N) MN-major in shared
//             memory; N 64 or 128 (the head dim)
// `accumulate` 0 overwrites d. The last argument picks bf16 or fp16 operands.
// The operand lists are written out: PTX takes no arrays.

__device__ __forceinline__ void wgmma_ss(float (&d)[16],
                                         uint64_t desc_a, uint64_t desc_b,
                                         int accumulate, __nv_bfloat16*) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16],
                                         uint64_t desc_a, uint64_t desc_b,
                                         int accumulate, __half*) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32],
                                         uint64_t desc_a, uint64_t desc_b,
                                         int accumulate, __nv_bfloat16*) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      " %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32],
                                         uint64_t desc_a, uint64_t desc_b,
                                         int accumulate, __half*) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      " %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t a[4], uint64_t desc_b,
                                         int accumulate, __nv_bfloat16*) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      " %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t a[4], uint64_t desc_b,
                                         int accumulate, __half*) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      " %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t a[4], uint64_t desc_b,
                                         int accumulate, __nv_bfloat16*) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      " %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t a[4], uint64_t desc_b,
                                         int accumulate, __half*) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      " %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

}  // namespace vpt
