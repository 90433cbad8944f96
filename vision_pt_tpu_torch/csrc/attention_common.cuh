// Helpers shared by the attention kernels (the forwards of attention_fwd.cuh,
// the backwards of attention_bwd.cuh, short_attention_bwd.cu and
// flash_attention_bwd.cu, the probes of attention_probe.cu) and the NF4
// kernel: constants of the softmax, the mma.sync product of 16-bit operands
// (bf16 or fp16, T below) and its fragment packing, tile loads of the same
// rows of two heads into padded shared memory, the two warp-level products
// of a 16-row slice, and a launch that raises the dynamic shared-memory
// limit first. Loads and stores move 16-bit patterns; only the mma
// instruction and the rounding of fp32 values tell bf16 and fp16 apart.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                         a3 (g+8, 2t+8..)
//   B (16x8, k by n):     b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16x8):             c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// so the C fragments of two adjacent 8-column tiles are, element for
// element, the A fragment of a 16-deep slice of the next product.
//
// ldmatrix.x4.trans: lane l gives the address of row (l % 8) of 8x8 matrix
// l / 8, and receives in register i the elements (2t, g) and (2t + 1, g) of
// matrix i, which is the B fragment b0 (or b1) of a product whose B is that
// matrix's (k, n) block stored row major.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace vpt {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
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

__device__ __forceinline__ void mma_f16_16816(float c[4], const uint32_t a[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b with fp32 accumulation, for operands of type T (bf16 or fp16)
template <typename T>
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    mma_f16_16816(c, a, b0, b1);
  else
    mma_bf16_16816(c, a, b0, b1);
}

// Two floats -> one register of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats -> one register of two T (bf16 or fp16, rounded to nearest
// even), the first in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// one 16-bit value of type T -> float
template <typename T>
__device__ __forceinline__ float to_float(T x) {
  if constexpr (std::is_same<T, __half>::value)
    return __half2float(x);
  else
    return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// rows [r0, r0 + rows) of two (S, D) head slices, a and b, with row strides
// `stride_a` and `stride_b` -> shared memory with row stride D + 8; rows at
// or past `limit` are zeros; a load of each in flight per thread
template <int D, typename T>
__device__ __forceinline__ void load_rows2_16(
    T* dst_a, T* dst_b, const T* src_a, const T* src_b, long long stride_a,
    long long stride_b, int r0, int rows, int limit) {
  constexpr int LD = D + 8, CH = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    uint4 a = zero, b = zero;
    if (r0 + r < limit) {
      a = *reinterpret_cast<const uint4*>(src_a + (r0 + r) * stride_a + c * 8);
      b = *reinterpret_cast<const uint4*>(src_b + (r0 + r) * stride_b + c * 8);
    }
    *reinterpret_cast<uint4*>(dst_a + r * LD + c * 8) = a;
    *reinterpret_cast<uint4*>(dst_b + r * LD + c * 8) = b;
  }
}

// rows [r0, r0 + rows) of a (S, D) fp32 head slice -> shared memory with row
// stride `ld`; rows at or past `limit` are zeros
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long stride, int r0,
                                              int rows, int limit, int ld) {
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = r0 + r < limit ? src[(r0 + r) * stride + c] : 0.f;
  }
}

// acc (16 x 8NT) = rows [r0, r0 + 16) of `as` times the first 8NT rows of
// `bs`, transposed (a q k^T-shaped product); both (rows, D) in shared memory
// with row stride D + 8. r0 = warp * 16 + g.
template <int D, int NT, typename T>
__device__ __forceinline__ void warp_abt(float acc[NT][4], const T* as,
                                         const T* bs, int r0, int g, int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const T* ab = as + r0 * LD + kk * 16 + 2 * t;
    const uint32_t a[4] = {ld32(ab), ld32(ab + 8 * LD), ld32(ab + 8),
                           ld32(ab + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const T* bb = bs + (j * 8 + g) * LD + kk * 16 + 2 * t;
      mma_16816<T>(acc[j], a, ld32(bb), ld32(bb + 8));
    }
  }
}

// out (16 x D) += T(f) (16 x 8NT, C fragments) times the first 8NT rows
// of `xs` ((rows, D) in shared memory with row stride D + 8): a p v-shaped
// product, B read with ldmatrix.trans.
template <int D, int NT, typename T>
__device__ __forceinline__ void warp_fx(float out[D / 8][4],
                                        const float f[NT][4], const T* xs,
                                        int lane) {
  constexpr int LD = D + 8;
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    const uint32_t fa[4] = {
        pack2<T>(f[2 * kc][0], f[2 * kc][1]),
        pack2<T>(f[2 * kc][2], f[2 * kc][3]),
        pack2<T>(f[2 * kc + 1][0], f[2 * kc + 1][1]),
        pack2<T>(f[2 * kc + 1][2], f[2 * kc + 1][3]),
    };
    // matrices: (k 0-7, n dn), (k 8-15, n dn), (k 0-7, n dn+1), (k 8-15, n dn+1)
    const T* base = xs + (kc * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, base + dn * 8);
      mma_16816<T>(out[dn], fa, b[0], b[1]);
      mma_16816<T>(out[dn + 1], fa, b[2], b[3]);
    }
  }
}

// sum over P adjacent lanes that share a row
template <int P>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 1; m < P; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
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
