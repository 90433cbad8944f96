// Hopper building blocks shared by the redesigned kernels (the 16-bit
// attention forward, attention_fwd.cuh; the 16-bit attention backwards,
// attention_bwd.cuh; the NF4 dequant-matmul, nf4_matmul.cu): asynchronous
// copies into shared memory (cp.async, 16, 8 or 4 bytes, zero-filled past an
// edge) with their groups, tensor-map copies (TMA) with their mbarriers, the
// SFU's exp2, the 128-byte swizzled tile layout that wgmma reads, its
// shared-memory matrix descriptors, and the warpgroup products
// (wgmma.mma_async) of 16-bit operands with fp32 accumulators.
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

#include <cuda.h>  // CUtensorMap

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

// ------------------------------------------------------- TMA and mbarriers
//
// A tensor map (CUtensorMap, made on the host by cuTensorMapEncodeTiled) lets
// one thread copy a whole box of a strided tensor into shared memory, in the
// 128-byte swizzle of the tiles above, with zeros past the tensor's edge;
// the copy counts its bytes against an mbarrier in shared memory, which the
// threads wait on.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes initialised mbarriers visible to the copy engine (and, after a
// barrier, to the other threads)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival, announcing `bytes` of copies to complete on `bar`
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// waits until the phase of parity `phase` of `bar` has completed; traps (a
// launch failure the caller sees) instead of hanging if it never does
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done) : "r"(addr), "r"(phase) : "memory");
    if (done) return;
    if (spins > (1u << 26)) __trap();
  }
}

// the box of a 4-D tensor map at element coordinates (c0, c1, c2, c3) into
// shared memory at `dst` (1024-byte aligned for the 128-byte swizzle),
// completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (nothing to
// link), or null
typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<TensorMapEncodeTiled>(fn);
  }
  return encode;
}

// makes the current device's primary context current on this host thread,
// as a launch would: the driver's tensor-map encoder needs one, and a thread
// that has made no runtime call yet (autograd's backward thread) has none
inline cudaError_t bind_current_device() {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  return err != cudaSuccess ? err : cudaSetDevice(device);
}

// a map over the (S, D) head slices of a (batch, row, head)-strided 16-bit
// tensor of type T (strides in elements): dimensions (D, S, H, B), boxes of
// 64 columns (one 128-byte panel) by `rows` rows, 128-byte swizzle, zeros
// past S. Returns 0, or the driver's error (a CUresult).
template <typename T>
inline int head_tensor_map(CUtensorMap* map, const void* base, int dim,
                            int seq, int heads, int batch, long long sb,
                            long long ss, long long sh, int rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t sizes[4] = {(cuuint64_t)dim, (cuuint64_t)seq,
                               (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * sizeof(T),
                                 (cuuint64_t)sh * sizeof(T),
                                 (cuuint64_t)sb * sizeof(T)};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 4, const_cast<void*>(base), sizes, strides, box,
                steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// ------------------------------------------------------------------ the SFU

// 2^x in one SFU instruction (ex2.approx.ftz: relative error about 2^-22,
// results below 2^-126 flushed to 0), where exp2f adds a range check and two
// multiplies for subnormal results; the 16-bit attention kernels take their
// softmax weights from it, which are rounded to 16 bits or summed against a
// row maximum of 1
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// the first 1024-byte boundary at or after `raw` (dynamic shared memory is
// only 16-byte aligned; a kernel asks for 1024 bytes of slack)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(raw);
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  return reinterpret_cast<unsigned char*>(base + ((1024 - (s & 1023)) & 1023));
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
//             memory; N 32, 64 or 128 (the s and dp of 32- to 128-key tiles)
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

__device__ __forceinline__ void wgmma_ss(float (&d)[64],
                                         uint64_t desc_a, uint64_t desc_b,
                                         int accumulate, __nv_bfloat16*) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      " %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64],
                                         uint64_t desc_a, uint64_t desc_b,
                                         int accumulate, __half*) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      " %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
