// Fused NF4/FP4 dequant-matmul for Hopper (sm_90a).
//
// Replaces vision_pt_tpu/ops/quant/pallas_nf4.py::dequant_matmul_4bit (its
// Pallas TPU kernel _dequant_matmul_kernel). It computes the same function:
//
//   y[m, o] = sum_j absmax_t[j, o] * sum_{r in chunk j} x[m, r] * code[q(r, o)]
//
// for x (M, K) bf16, fp16 or fp32, packed_t (K/2, N) uint8 whose byte (r, o) holds
// the code of input row r in its high nibble and of row r + K/2 in its low
// nibble, and absmax_t (K/64, N) fp32. Each 64-row chunk j is an fp32 partial
// product of x with the UNSCALED codebook values (bf16 values for bf16 x, the
// bit patterns of the JAX package's _code_i16; for fp16 x the fp32 codebook
// rounded to fp16, as the JAX kernel's cast to x's type; fp32 values for fp32
// x), scaled
// by absmax_t[j] and added to an fp32 accumulator (a multiply, then an add:
// no fused rounding); y is rounded once, to x's type. M and N are arbitrary
// (N % 8 == 0, K % 128 == 0): the kernel guards its edges where the TPU
// wrapper padded to blocks.
//
// Bound on an H100 SXM at the SDXL sampler's shape (M 154 context rows of
// the cross-attention to_k / to_v, K 2048, N 1280, bf16):
//   FLOPs  2 * M * K * N = 0.81 GFLOP -> / 989 TFLOP/s = 0.82 us
//   bytes  x 0.63 MB + codes 1.31 MB + absmax 0.16 MB + y 0.39 MB = 2.5 MB
//          -> / 3.35 TB/s = 0.75 us
// so it is a launch-sized product (about 1 us either way). At the JAX
// package's bench shape (M 64, K = N = 8192) the 32 MB of codes dominate:
// about 12 us by bytes, where a dense bf16 weight would be 128 MB.
//
// Design (simple first). The TPU kernel decodes with a 16-way select tree
// because Mosaic has no gather; here a 16-entry table in shared memory does
// it. One block (4 warps) owns a 64-row by 64-column output tile and walks
// the K/128 byte rows of packed_t: each 64 x 64 byte tile is read once (8
// bytes a thread) and decoded into both of its chunks (j and j + K/128) as
// bf16 (fp16, fp32) tiles in shared memory, beside the two 64 x 64 tiles of
// x. bf16 and fp16: each warp runs mma.sync m16n8k16 over its 16 rows (B read
// with ldmatrix.trans), fp32 partial sums in registers, scaled per column and
// added to the accumulator. fp32: scalar FMA, each thread 8 rows x 4
// columns. No pipelining of the loads, no wgmma, TMA or split-K: those are
// later work (at the sampler's shape 60 blocks fill under half the SMs).

#include <cuda_fp16.h>
#include <string.h>

#include "attention_common.cuh"

namespace {

using vpt::ld32;
using vpt::ldsm_x4_trans;
using vpt::pack_bf16;

constexpr int BM = 64;  // rows of x per block
constexpr int BN = 64;  // output columns per block
constexpr int BK = 64;  // the absmax block: one chunk of K
constexpr int THREADS = 128;

struct Params {
  const void* x;          // (M, K), row stride K
  const uint8_t* packed;  // (K/2, N)
  const float* absmax;    // (K/64, N)
  void* out;              // (M, N)
  int m, k, n;
  float lut[16];          // the codebook, fp32
};

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int LD = BK + 8;  // 144-byte rows: ldmatrix and mma reads
};                                   // without bank conflicts
template <>
struct Tile<__half> : Tile<__nv_bfloat16> {};
template <>
struct Tile<float> {
  static constexpr int LD = BK + 4;  // 16-byte aligned float4 rows
};

template <typename T>
constexpr size_t smem_bytes() {
  // x tiles [2][BM][LD] and decoded weight tiles [2][BK][LD], then the
  // scales [2][BN]
  return 2 * (BM + BK) * Tile<T>::LD * sizeof(T) + 2 * BN * sizeof(float);
}

// 8 codes of one nibble (shift 4: high, 0: low) of the 8 bytes in v ->
// 8 values at dst (bf16 or fp16: one 16-byte store; fp32: two)
template <typename T>
__device__ __forceinline__ void decode8(T* dst, uint2 v, int shift,
                                        const uint32_t* lut) {
  static_assert(sizeof(T) == 2, "16-bit operands");
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t word = q < 2 ? v.x : v.y;
    const uint32_t b0 = (word >> (16 * (q & 1))) & 0xffu;
    const uint32_t b1 = (word >> (16 * (q & 1) + 8)) & 0xffu;
    w[q] = lut[(b0 >> shift) & 15u] | (lut[(b1 >> shift) & 15u] << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void decode8(float* dst, uint2 v, int shift,
                                        const uint32_t* lut) {
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t byte = ((i < 4 ? v.x : v.y) >> (8 * (i & 3))) & 0xffu;
    f[i] = __uint_as_float(lut[(byte >> shift) & 15u]);
  }
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// rows [m0, m0 + BM) x columns [c0, c0 + BK) of x -> dst [BM][LD]; rows at or
// past m are zeros
template <typename T>
__device__ __forceinline__ void load_x(T* dst, const T* x, int m0, int c0,
                                       const Params& p) {
  constexpr int LD = Tile<T>::LD, V = 16 / sizeof(T), CH = BK / V;
  for (int i = threadIdx.x; i < BM * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < p.m)
      val = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * p.k + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1,
                                          __nv_bfloat16*) {
  vpt::mma_bf16_16816(c, a, b0, b1);
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1, __half*) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// part (16 x 64, C fragments) = rows [16 warp, 16 warp + 16) of xs (BM x BK)
// times ws (BK x BN, row major; B fragments by ldmatrix.trans); then
// acc += part * scale per column. T is bf16 or fp16: the loads move 16-bit
// patterns, only the mma tells the two apart.
template <typename T>
__device__ __forceinline__ void chunk_product(float acc[8][4], const T* xs16,
                                              const T* ws16, const float* sc) {
  constexpr int LD = Tile<T>::LD;
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(xs16);
  const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(ws16);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, mr = lane & 7;
  float part[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    const __nv_bfloat16* ab = xs + (warp * 16 + g) * LD + kc * 16 + 2 * t;
    const uint32_t a[4] = {ld32(ab), ld32(ab + 8 * LD), ld32(ab + 8),
                           ld32(ab + 8 * LD + 8)};
    // matrices: (k 0-7, n dn), (k 8-15, n dn), (k 0-7, n dn+1), (k 8-15, n dn+1)
    const __nv_bfloat16* base = ws + (kc * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;
#pragma unroll
    for (int dn = 0; dn < BN / 8; dn += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, base + dn * 8);
      mma_16816(part[dn], a, b[0], b[1], (T*)nullptr);
      mma_16816(part[dn + 1], a, b[2], b[3], (T*)nullptr);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = __fadd_rn(acc[j][e], __fmul_rn(part[j][e], sc[j * 8 + 2 * t + (e & 1)]));
}

// fp32: thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 8 i (i < 8) and
// columns 4 tx .. 4 tx + 3
__device__ __forceinline__ void chunk_product(float acc[8][4], const float* xs,
                                              const float* ws, const float* sc) {
  constexpr int LD = Tile<float>::LD;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float part[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[i][c] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    const float4 b = *reinterpret_cast<const float4*>(ws + kk * LD + 4 * tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = xs[(ty + 8 * i) * LD + kk];
      part[i][0] = fmaf(a, b.x, part[i][0]);
      part[i][1] = fmaf(a, b.y, part[i][1]);
      part[i][2] = fmaf(a, b.z, part[i][2]);
      part[i][3] = fmaf(a, b.w, part[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(part[i][c], sc[4 * tx + c]));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16*) {
  return pack_bf16(lo, hi);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half*) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ void store(const float acc[8][4], const Params& p,
                                      int m0, int n0, T*) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    if (row >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (col < p.n)
        *reinterpret_cast<uint32_t*>(out + (long long)row * p.n + col) =
            pack2(acc[j][2 * r], acc[j][2 * r + 1], (T*)nullptr);
    }
  }
}

__device__ __forceinline__ void store(const float acc[8][4], const Params& p,
                                      int m0, int n0, float*) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int col = n0 + 4 * tx;
  if (col >= p.n) return;
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty + 8 * i;
    if (row < p.m)
      *reinterpret_cast<float4*>(out + (long long)row * p.n + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

__device__ __forceinline__ uint32_t lut_bits(float v, __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t lut_bits(float v, __half*) {
  return __half_as_ushort(__float2half_rn(v));
}
__device__ __forceinline__ uint32_t lut_bits(float v, float*) {
  return __float_as_uint(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) nf4_matmul_kernel(const Params p) {
  constexpr int LD = Tile<T>::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                        // [2][BM][LD]
  T* ws = xs + 2 * BM * LD;                                  // [2][BK][LD]
  float* sc = reinterpret_cast<float*>(ws + 2 * BK * LD);    // [2][BN]
  __shared__ uint32_t lut[16];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  if (threadIdx.x < 16) lut[threadIdx.x] = lut_bits(p.lut[threadIdx.x], (T*)nullptr);
  const T* x = static_cast<const T*>(p.x);
  const int byte_rows = p.k / (2 * BK);  // chunk j pairs with j + byte_rows

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int br = 0; br < byte_rows; ++br) {
    __syncthreads();  // the previous tiles are consumed (and lut is written)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      load_x(xs + h * BM * LD, x, m0, (br + h * byte_rows) * BK, p);
    for (int i = threadIdx.x; i < BK * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      uint2 v = make_uint2(0u, 0u);
      if (n0 + c < p.n)
        v = *reinterpret_cast<const uint2*>(p.packed + (long long)(br * BK + r) * p.n + n0 + c);
      decode8(ws + r * LD + c, v, 4, lut);
      decode8(ws + BK * LD + r * LD + c, v, 0, lut);
    }
    for (int i = threadIdx.x; i < 2 * BN; i += THREADS) {
      const int h = i / BN, c = i % BN;
      sc[i] = n0 + c < p.n ? p.absmax[(long long)(br + h * byte_rows) * p.n + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      chunk_product(acc, xs + h * BM * LD, ws + h * BK * LD, sc + h * BN);
  }
  store(acc, p, m0, n0, (T*)nullptr);
}

}  // namespace

// dtype 0: bf16, 1: fp32, 2: fp16. lut: the 16 codebook values (host memory). Returns
// the CUDA error of the launch (0 on success).
extern "C" int vpt_nf4_matmul(const void* x, const void* packed,
                              const void* absmax, void* out, int m, int k,
                              int n, const float* lut, int dtype,
                              void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % (2 * BK) != 0 || n % 8 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.packed = static_cast<const uint8_t*>(packed);
  p.absmax = static_cast<const float*>(absmax);
  p.out = out;
  p.m = m;
  p.k = k;
  p.n = n;
  memcpy(p.lut, lut, sizeof(p.lut));
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vpt::launch(nf4_matmul_kernel<__nv_bfloat16>, p, grid, THREADS,
                       smem_bytes<__nv_bfloat16>(), s);
  if (dtype == 1)
    return vpt::launch(nf4_matmul_kernel<float>, p, grid, THREADS,
                       smem_bytes<float>(), s);
  if (dtype == 2)
    return vpt::launch(nf4_matmul_kernel<__half>, p, grid, THREADS,
                       smem_bytes<__half>(), s);
  return (int)cudaErrorInvalidValue;
}
