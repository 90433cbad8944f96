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
// x), scaled by absmax_t[j] and added to an fp32 accumulator (a multiply,
// then an add: no fused rounding); y is rounded once, to x's type. M and N
// are arbitrary (N % 8 == 0, K % 128 == 0): the kernel guards its edges
// where the TPU wrapper padded to blocks.
//
// Order of the sums. K is walked in k-steps of 64 byte rows of packed_t; k-step
// i holds chunks i and i + K/128 and adds them in that order. The k-steps are
// cut into `splits` contiguous ranges (split s: [s * steps / splits,
// (s + 1) * steps / splits)), each summed from 0 by its own block; with more
// than one split a second kernel adds the splits' fp32 sums in order
// 0, 1, ... and rounds. The wrapper (ops/quant/nf4_matmul.py, plan) picks
// the block shape and the splits from (M, K, N, dtype), and its plain version
// repeats this order, so that a result repeats bit for bit from call to call.
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
// Design. A product this close to the card's
// ops-per-byte ridge is held back by bytes in flight, not by the matrix
// instruction, so this version keeps mma.sync and spends its effort on
// loads: one 8-warp block (warps 4 over rows x 2 over columns) owns a BM x
// BN output tile and one split of K, so that the grid fills the 132 SMs
// once (twice for the 64-row shape, whose blocks fit two an SM); a ring of
// STAGES k-steps (x's two 64-column
// pieces, the 64 x BN code bytes, the two scale rows) is filled by cp.async
// (16-byte loads for x and the scales; codes 16-byte in 64-column tiles
// where N % 16 == 0, else 8-byte: in 32-column tiles 16-byte code loads
// measured slower, PERF.md), zero-filled past M and N; each k-step's codes are
// decoded once, through a 16-entry table, into both chunks' T tiles in
// shared memory, which every warp reads with ldmatrix.trans. Block shapes:
// BM x BN = 64 x 64 for M <= 64 (4 stages, 110 KB: two blocks an SM), 128
// x 64 for M <= 128 (3), 256 x 32 above (2): one block covers every row of
// x up to M 256, so at
// M 154 each code is read and decoded once. fp32 x takes 64 x 64 tiles and
// scalar FMA (3 stages). wgmma is not used: at M <= 154 its 64-row
// instruction would not raise the bytes in flight, which set the time here.

#include "hopper.cuh"

#include <string.h>

namespace {

using namespace vpt;

constexpr int THREADS = 256;
constexpr int BK = 64;  // the absmax block: one chunk of K

// block shape: warps 4 (rows) x 2 (columns), each warp MW m16 tiles x NW n8
// tiles (16-bit x); fp32 x: 64 x 64, threads 16 x 16 with 4 x 4 outputs
template <typename T, int MW, int NW, int STAGES>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int BM = kF32 ? 64 : 64 * MW;
  static constexpr int BN = kF32 ? 64 : 16 * NW;
  static constexpr int XLD = BK + 16 / (int)sizeof(T);  // x row, padded 16 B
  static constexpr int WLD = BN + 16 / (int)sizeof(T);  // weight row, padded
  // one ring stage: x [2][BM][XLD], codes [BK][BN] bytes, scales [2][BN]
  static constexpr int X_BYTES = 2 * BM * XLD * sizeof(T);
  static constexpr int C_BYTES = BK * BN;
  static constexpr int STAGE = X_BYTES + C_BYTES + 2 * BN * 4;
  static constexpr int W_BYTES = 2 * BK * WLD * sizeof(T);
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + W_BYTES;
};

struct Params {
  const void* x;          // (M, K), row stride K
  const uint8_t* packed;  // (K/2, N)
  const float* absmax;    // (K/64, N)
  void* out;              // (M, N), when splits == 1
  float* ws;              // (splits, M, N) fp32, when splits > 1
  int m, k, n, splits;
  int wide;               // N % 16 == 0 and packed 16-byte aligned
  float lut[16];          // the codebook, fp32
};

__device__ __forceinline__ uint32_t lut_bits(float v, __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t lut_bits(float v, __half*) {
  return __half_as_ushort(__float2half_rn(v));
}
__device__ __forceinline__ uint32_t lut_bits(float v, float*) {
  return __float_as_uint(v);
}

// 8 codes of one nibble (shift 4: high, 0: low) of the 8 bytes in v ->
// 8 values at dst (16-bit: one 16-byte store; fp32: two)
template <typename T>
__device__ __forceinline__ void decode8(T* dst, uint2 v, int shift,
                                        const uint32_t* lut) {
  if constexpr (sizeof(T) == 2) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t word = q < 2 ? v.x : v.y;
      const uint32_t b0 = (word >> (16 * (q & 1))) & 0xffu;
      const uint32_t b1 = (word >> (16 * (q & 1) + 8)) & 0xffu;
      w[q] = lut[(b0 >> shift) & 15u] | (lut[(b1 >> shift) & 15u] << 16);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t byte = ((i < 4 ? v.x : v.y) >> (8 * (i & 3))) & 0xffu;
      f[i] = __uint_as_float(lut[(byte >> shift) & 15u]);
    }
    *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// k-step `step` into ring stage `st`: x columns [64 step, +64) and
// [K/2 + 64 step, +64) of rows [m0, m0 + BM), code rows [64 step, +64) and
// scale rows step, step + K/128 of columns [n0, n0 + BN); one commit group
template <typename T, typename C>
__device__ __forceinline__ void issue_step(unsigned char* st, int step,
                                           const Params& p, int m0, int n0) {
  // every index below divides by a power of two: shifts, not divisions
  constexpr int V = 16 / sizeof(T), XCH = BK / V;
  const T* x = static_cast<const T*>(p.x);
  T* xs = reinterpret_cast<T*>(st);
#pragma unroll 4
  for (int i = threadIdx.x; i < 2 * C::BM * XCH; i += THREADS) {
    const int h = i / (C::BM * XCH), r = (i / XCH) % C::BM, c = (i % XCH) * V;
    const bool ok = m0 + r < p.m;
    const T* src = ok ? x + (long long)(m0 + r) * p.k + h * (p.k / 2) + step * BK + c
                      : x;
    cp_async16(xs + (h * C::BM + r) * C::XLD + c, src, ok);
  }
  uint8_t* cs = st + C::X_BYTES;
  if (C::BN == 64 && p.wide) {  // 16-byte code loads
#pragma unroll 2
    for (int i = threadIdx.x; i < BK * (C::BN / 16); i += THREADS) {
      const int r = i / (C::BN / 16), c = (i % (C::BN / 16)) * 16;
      const bool ok = n0 + c < p.n;
      cp_async16(cs + r * C::BN + c,
                 ok ? p.packed + (long long)(step * BK + r) * p.n + n0 + c : p.packed,
                 ok);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < BK * (C::BN / 8); i += THREADS) {
      const int r = i / (C::BN / 8), c = (i % (C::BN / 8)) * 8;
      const bool ok = n0 + c < p.n;
      cp_async8(cs + r * C::BN + c,
                ok ? p.packed + (long long)(step * BK + r) * p.n + n0 + c : p.packed,
                ok);
    }
  }
  float* sc = reinterpret_cast<float*>(cs + C::C_BYTES);
  for (int i = threadIdx.x; i < 2 * (C::BN / 4); i += THREADS) {
    const int h = i / (C::BN / 4), c = (i % (C::BN / 4)) * 4;
    const bool ok = n0 + c < p.n;
    const long long row = step + h * (p.k / (2 * BK));
    cp_async16(sc + h * C::BN + c, ok ? p.absmax + row * p.n + n0 + c : p.absmax,
               ok);
  }
}

// 16-bit x: part = x chunk (this warp's 16 MW rows x 64) times w chunk
// (64 x this warp's 8 NW columns), then acc += part * scale per column
template <typename T, typename C, int MW, int NW>
__device__ __forceinline__ void chunk_mma(float (&acc)[MW][NW][4],
                                          const T* xs, const T* ws,
                                          const float* sc, int wm, int wn,
                                          int live) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, mr = lane & 7;
  float part[MW][NW][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    uint32_t b[NW][2];
    // matrices: (k 0-7, n dn), (k 8-15, n dn), (k 0-7, n dn+1), (k 8-15, n dn+1)
    const T* base = ws + (kc * 16 + (mi & 1) * 8 + mr) * C::WLD + wn * 8 * NW +
                    (mi >> 1) * 8;
#pragma unroll
    for (int j = 0; j < NW; j += 2) {
      uint32_t r4[4];
      ldsm_x4_trans(r4, base + j * 8);
      b[j][0] = r4[0];
      b[j][1] = r4[1];
      b[j + 1][0] = r4[2];
      b[j + 1][1] = r4[3];
    }
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      if (i >= live) continue;  // rows of this m16 tile are all past M
      const T* ab = xs + (wm * 16 * MW + i * 16 + g) * C::XLD + kc * 16 + 2 * t;
      const uint32_t a[4] = {ld32(ab), ld32(ab + 8 * C::XLD), ld32(ab + 8),
                             ld32(ab + 8 * C::XLD + 8)};
#pragma unroll
      for (int j = 0; j < NW; ++j) mma_16816<T>(part[i][j], a, b[j][0], b[j][1]);
    }
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const float2 s2 = *reinterpret_cast<const float2*>(sc + wn * 8 * NW + j * 8 + 2 * t);
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][j][e] = __fadd_rn(acc[i][j][e],
                                 __fmul_rn(part[i][j][e], (e & 1) ? s2.y : s2.x));
  }
}

// fp32 x: thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i (i < 4)
// and columns 4 tx .. 4 tx + 3 of the 64 x 64 tile
template <typename C>
__device__ __forceinline__ void chunk_fma(float (&acc)[4][4], const float* xs,
                                          const float* ws, const float* sc) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[i][c] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    const float4 b = *reinterpret_cast<const float4*>(ws + kk * C::WLD + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = xs[(ty + 16 * i) * C::XLD + kk];
      part[i][0] = fmaf(a, b.x, part[i][0]);
      part[i][1] = fmaf(a, b.y, part[i][1]);
      part[i][2] = fmaf(a, b.z, part[i][2]);
      part[i][3] = fmaf(a, b.w, part[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(part[i][c], sc[4 * tx + c]));
}

template <typename T, int MW, int NW, int STAGES>
__global__ void __launch_bounds__(THREADS) nf4_matmul_kernel(const Params p) {
  using C = Cfg<T, MW, NW, STAGES>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                 // [STAGES][STAGE]
  T* ws = reinterpret_cast<T*>(smem + STAGES * C::STAGE);     // [2][BK][WLD]
  __shared__ uint32_t lut[16];

  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM, split = blockIdx.z;
  const int steps = p.k / (2 * BK);
  const int s0 = (int)((long long)split * steps / p.splits);
  const int s1 = (int)((long long)(split + 1) * steps / p.splits);
  const int nsteps = s1 - s0;
  if (threadIdx.x == 0) {  // constant indices keep the parameters off the stack
#pragma unroll
    for (int i = 0; i < 16; ++i) lut[i] = lut_bits(p.lut[i], (T*)nullptr);
  }

  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  // m16 tiles of this warp with a row below M
  const int live = min(MW, max(0, (p.m - m0 - wm * 16 * MW + 15) / 16));

  constexpr int AM = C::kF32 ? 4 : MW, AN = C::kF32 ? 1 : NW;
  float acc[AM][AN][4];
#pragma unroll
  for (int i = 0; i < AM; ++i)
#pragma unroll
    for (int j = 0; j < AN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) issue_step<T, C>(ring + s * C::STAGE, s0 + s, p, m0, n0);
    cp_async_commit();
  }
  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<STAGES - 2>();  // k-step it has landed
    __syncthreads();              // ... for every thread; the weight tiles
                                  // and stage it - 1 are free
    {
      const int nxt = it + STAGES - 1;
      if (nxt < nsteps)
        issue_step<T, C>(ring + (nxt % STAGES) * C::STAGE, s0 + nxt, p, m0, n0);
      cp_async_commit();
    }
    const unsigned char* st = ring + (it % STAGES) * C::STAGE;
    const T* xs = reinterpret_cast<const T*>(st);
    const uint8_t* cs = st + C::X_BYTES;
    const float* sc = reinterpret_cast<const float*>(cs + C::C_BYTES);
    for (int i = threadIdx.x; i < BK * (C::BN / 8); i += THREADS) {
      const int r = i / (C::BN / 8), c = (i % (C::BN / 8)) * 8;
      const uint2 v = *reinterpret_cast<const uint2*>(cs + r * C::BN + c);
      decode8(ws + r * C::WLD + c, v, 4, lut);
      decode8(ws + (BK + r) * C::WLD + c, v, 0, lut);
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (C::kF32)
        chunk_fma<C>(reinterpret_cast<float(&)[4][4]>(acc),
                     reinterpret_cast<const float*>(xs) + h * C::BM * C::XLD,
                     reinterpret_cast<const float*>(ws) + h * BK * C::WLD,
                     sc + h * C::BN);
      else
        chunk_mma<T, C, MW, NW>(acc, xs + h * C::BM * C::XLD, ws + h * BK * C::WLD,
                                sc + h * C::BN, wm, wn, live);
    }
  }
  cp_async_wait<0>();

  // epilogue: round to T (one split) or write the split's fp32 sum
  if constexpr (C::kF32) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16, col = n0 + 4 * tx;
    if (col >= p.n) return;
    float* out = p.splits == 1 ? static_cast<float*>(p.out)
                               : p.ws + (long long)split * p.m * p.n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < p.m)
        *reinterpret_cast<float4*>(out + (long long)row * p.n + col) =
            make_float4(acc[i][0][0], acc[i][0][1], acc[i][0][2], acc[i][0][3]);
    }
  } else {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm * 16 * MW + i * 16 + g + 8 * r;
        if (row >= p.m) continue;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int col = n0 + wn * 8 * NW + j * 8 + 2 * t;
          if (col >= p.n) continue;
          const long long off = (long long)row * p.n + col;
          if (p.splits == 1)
            *reinterpret_cast<uint32_t*>(static_cast<T*>(p.out) + off) =
                pack2<T>(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
          else
            *reinterpret_cast<float2*>(p.ws + (long long)split * p.m * p.n + off) =
                make_float2(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
        }
      }
  }
}

// y = T(ws[0] + ws[1] + ...), the splits added in order; 4 outputs a thread
template <typename T>
__global__ void __launch_bounds__(256) nf4_reduce_kernel(const Params p) {
  const long long total = (long long)p.m * p.n;  // a multiple of 8
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= total) return;
  float4 a = *reinterpret_cast<const float4*>(p.ws + i);
  for (int s = 1; s < p.splits; ++s) {
    const float4 b = *reinterpret_cast<const float4*>(p.ws + s * total + i);
    a.x = __fadd_rn(a.x, b.x);
    a.y = __fadd_rn(a.y, b.y);
    a.z = __fadd_rn(a.z, b.z);
    a.w = __fadd_rn(a.w, b.w);
  }
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(static_cast<float*>(p.out) + i) = a;
  } else {
    *reinterpret_cast<uint2*>(static_cast<T*>(p.out) + i) =
        make_uint2(pack2<T>(a.x, a.y), pack2<T>(a.z, a.w));
  }
}

template <typename T, int MW, int NW, int STAGES>
int run(const Params& p, cudaStream_t s) {
  using C = Cfg<T, MW, NW, STAGES>;
  const dim3 grid((p.n + C::BN - 1) / C::BN, (p.m + C::BM - 1) / C::BM, p.splits);
  int rc = launch(nf4_matmul_kernel<T, MW, NW, STAGES>, p, grid, THREADS, C::SMEM, s);
  if (rc != 0 || p.splits == 1) return rc;
  const long long quads = (long long)p.m * p.n / 4;
  nf4_reduce_kernel<T><<<(unsigned)((quads + 255) / 256), 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int run_shape(const Params& p, int shape, cudaStream_t s) {
  if (shape == 0) return run<T, 1, 4, 4>(p, s);  // 64 x 64, two blocks an SM
  if (shape == 1) return run<T, 2, 4, 3>(p, s);  // 128 x 64
  if (shape == 2) return run<T, 4, 2, 2>(p, s);  // 256 x 32
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype 0: bf16, 1: fp32, 2: fp16. shape: the block shape (0: 64 x 64,
// 1: 128 x 64, 2: 256 x 32 for 16-bit x; fp32 x takes 64 x 64 whatever it
// is), splits: the K ranges; both from the wrapper's plan. ws: fp32 scratch
// of splits * M * N when splits > 1. lut: the 16 codebook values (host
// memory). Returns the CUDA error of the launches (0 on success).
extern "C" int vpt_nf4_matmul(const void* x, const void* packed,
                              const void* absmax, void* out, float* ws, int m,
                              int k, int n, const float* lut, int dtype,
                              int shape, int splits, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % (2 * BK) != 0 || n % 8 != 0 ||
      splits < 1 || splits > k / (2 * BK) || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.packed = static_cast<const uint8_t*>(packed);
  p.absmax = static_cast<const float*>(absmax);
  p.out = out;
  p.ws = ws;
  p.m = m;
  p.k = k;
  p.n = n;
  p.splits = splits;
  p.wide = n % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  memcpy(p.lut, lut, sizeof(p.lut));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_shape<__nv_bfloat16>(p, shape, s);
  if (dtype == 2) return run_shape<__half>(p, shape, s);
  if (dtype == 1) return run<float, 1, 4, 3>(p, s);
  return (int)cudaErrorInvalidValue;
}
