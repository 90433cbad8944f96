// Helpers shared by the packed short-attention kernels (forward in
// short_attention.cu, backward in short_attention_bwd.cu): constants of the
// softmax, the mma.sync bf16 product and its fragment packing, and a launch
// that raises the dynamic shared-memory limit first.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                         a3 (g+8, 2t+8..)
//   B (16x8, k by n):     b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16x8):             c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// so the C fragments of two adjacent 8-column tiles are, element for
// element, the A fragment of a 16-deep slice of the next product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vpt {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClip = 60.0f;                         // BOUNDED_LOGIT_CLIP
constexpr float kDenomFloor = 7.888609052210118e-31f;  // 2^-100
constexpr float kNegInf = -1e30f;

// kv_lens[b] clamped to [0, sk]; "all sk keys" when kv_lens is null.
__device__ __forceinline__ int clamped_len(const int* kv_lens, int b, int sk) {
  const int kv = kv_lens != nullptr ? kv_lens[b] : sk;
  return min(max(kv, 0), sk);
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(const __nv_bfloat16& lo,
                                             const __nv_bfloat16& hi) {
  uint32_t l = *reinterpret_cast<const uint16_t*>(&lo);
  uint32_t h = *reinterpret_cast<const uint16_t*>(&hi);
  return l | (h << 16);
}

template <typename Kernel, typename Params>
int launch(Kernel kernel, const Params& p, dim3 grid, int threads, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace vpt
