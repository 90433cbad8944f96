// Packed short-sequence attention, forward, for Hopper (sm_90a).
//
// Replaces vision_pt_tpu/ops/short_attention.py::_fwd_kernel_packed, the
// Pallas TPU kernel behind short_attention_packed (forward). It computes the
// same function, not the same schedule:
//
//   o[b, i, h] = sum_j e[i, j] * v[b, j, h] / max(sum_j e[i, j], 2^-100)
//
// over heads that live as D-wide column slices of (B, S, H*D) tensors (read
// in place through the strides the wrapper passes; no transposes), with
// per-batch suffix key lengths kv_lens (clamped to Sk; a row with kv_len 0
// gives 0). Logits are scaled into the exp2 domain. bounded=1 clips them at
// +-60*log2(e) and exponentiates without max subtraction (exact softmax
// inside the clip: QKNorm bounds the logits); bounded=0 subtracts a running
// row max (online softmax across key tiles). The unnormalised weights are
// cast to v's type before the PV product, accumulation is fp32, and the
// (Sq, D) output is divided by the row sums at the end.
//
// Bound at the JiT-B/16 256^2 sampler shape (B=16 rows with CFG, S=266,
// H=12, D=64, bf16, bounded, no kv_lens), on an H100 SXM:
//   bytes  q, k, v read and o written: 4 * 16*266*768*2 B = 26.1 MB
//          -> 26.1 MB / 3.35 TB/s = 7.8 us
//   FLOPs  4*B*H*S^2*D = 3.48 GFLOP -> 3.48 GFLOP / 989 TFLOP/s = 3.5 us
// so the kernel is bound by memory, at about 7.8 us per launch.
//
// Design (simple first). One thread block per (tile of 64 query rows, head,
// batch). The TPU kernel keeps a whole (S, S) score tile in VMEM; here K and
// V go through shared memory in tiles of 64 keys, and a loop over key tiles
// stops at kv_len. bf16 inputs use mma.sync m16n8k16 (bf16 in, fp32
// accumulate): each of 4 warps owns 16 query rows, keeps its Q fragments and
// its (16, D) output accumulator in registers, and turns the score
// accumulator into the A operand of the PV product without a trip through
// shared memory. fp32 inputs take a scalar FMA kernel (one thread per query
// row), so that fp32 stays fp32. The TPU kernel's head pairing is not
// ported: it only fills the TPU's 128-deep matrix unit. wgmma, TMA and a
// persistent schedule are left for later work.

#include "short_attention_common.cuh"

using namespace vpt;

namespace {

constexpr int kRows = 64;         // query rows per block
constexpr int kKeysBf16 = 64;     // keys per shared-memory tile, bf16 kernel
constexpr int kKeysF32 = 16;      // keys per shared-memory tile, fp32 kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_lens;  // (B,) or null for "all Sk keys"
  int sq, sk;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;  // elements
  float scale_log2;  // scale * log2(e)
  int bounded;
};

__device__ __forceinline__ int clamped_kv_len(const Params& p, int b) {
  return clamped_len(p.kv_lens, b, p.sk);
}

// ---------------------------------------------------------------- bf16 / mma
//
// Fragment layouts: short_attention_common.cuh. The C fragments of two
// adjacent 8-key score tiles are the A fragment of a 16-key slice of the PV
// product.

template <int D>
__global__ void __launch_bounds__(128) packed_fwd_bf16(Params p) {
  constexpr int LD = D + 8;  // padded smem row, in bf16 elements
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int NT = kKeysBf16 / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kRows * LD;
  __nv_bfloat16* vs = ks + kKeysBf16 * LD;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kv = clamped_kv_len(p, b);

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * D;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * D;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * D;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * D;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kRows * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    uint4 val = zero;
    if (q0 + r < p.sq)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.q_ss + c * 8);
    *reinterpret_cast<uint4*>(qs + r * LD + c * 8) = val;
  }
  __syncthreads();

  uint32_t qa[D / 16][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = qs + r0 * LD + kk * 16 + 2 * t;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // rows g and g+8 (unbounded only)
  float l_run[2] = {0.f, 0.f};          // this thread's partial row sums
  const float lim = kClip * kLog2e;

  for (int k0 = 0; k0 < kv; k0 += kKeysBf16) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kKeysBf16 * CH; i += blockDim.x) {
      const int r = i / CH, c = i % CH;
      uint4 kval = zero, vval = zero;
      if (k0 + r < kv) {  // rows past kv_len stay 0: no NaN reaches e @ v
        kval = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.k_ss + c * 8);
        vval = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.v_ss + c * 8);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c * 8) = kval;
      *reinterpret_cast<uint4*>(vs + r * LD + c * 8) = vval;
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kb = ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16_16816(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kb),
                       *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    if (p.bounded) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const float x = fminf(fmaxf(s[j][e] * p.scale_log2, -lim), lim);
          s[j][e] = col < kv ? exp2f(x) : 0.f;
        }
    } else {
      float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          s[j][e] = col < kv ? s[j][e] * p.scale_log2 : kNegInf;
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[j][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = tile_max[r];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);  // finite: k0 < kv
        const float alpha = exp2f(m_run[r] - m_new);
        l_run[r] *= alpha;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          acc[dn][2 * r] *= alpha;
          acc[dn][2 * r + 1] *= alpha;
        }
        m_run[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          s[j][e] = col < kv ? exp2f(s[j][e] - m_run[e >> 1]) : 0.f;
        }
    }

#pragma unroll
    for (int j = 0; j < NT; ++j) {
      l_run[0] += s[j][0] + s[j][1];
      l_run[1] += s[j][2] + s[j][3];
    }

#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* vb = vs + (kc * 16 + 2 * t) * LD + dn * 8 + g;
        mma_bf16_16816(acc[dn], pa, pack_raw(vb[0], vb[LD]),
                       pack_raw(vb[8 * LD], vb[9 * LD]));
      }
    }
  }

  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    denom[r] = fmaxf(l, kDenomFloor);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= p.sq) continue;
    __nv_bfloat16* orow = og + row * p.o_ss + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8) =
          pack_bf16(acc[dn][2 * r] / denom[r], acc[dn][2 * r + 1] / denom[r]);
  }
}

// ------------------------------------------------------------ fp32 / scalar

template <int D>
__global__ void __launch_bounds__(kRows) packed_fwd_f32(Params p) {
  constexpr int QLD = D + 1;  // odd stride: row-per-thread reads hit 32 banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kRows * QLD;
  float* vs = ks + kKeysF32 * D;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int kv = clamped_kv_len(p, b);

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * D;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * D;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * D;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * D;

  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    qs[r * QLD + c] = q0 + r < p.sq ? qg[(q0 + r) * p.q_ss + c] : 0.f;
  }

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m_run = kNegInf, l_run = 0.f;
  const float lim = kClip * kLog2e;
  const float* qrow = qs + tid * QLD;

  for (int k0 = 0; k0 < kv; k0 += kKeysF32) {
    __syncthreads();
    for (int i = tid; i < kKeysF32 * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < kv;
      ks[i] = in ? kg[(k0 + r) * p.k_ss + c] : 0.f;
      vs[i] = in ? vg[(k0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[kKeysF32];
#pragma unroll
    for (int j = 0; j < kKeysF32; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], ks[j * D + d], dot);
      s[j] = dot * p.scale_log2;
    }
    if (p.bounded) {
#pragma unroll
      for (int j = 0; j < kKeysF32; ++j)
        s[j] = k0 + j < kv ? exp2f(fminf(fmaxf(s[j], -lim), lim)) : 0.f;
    } else {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysF32; ++j)
        if (k0 + j < kv) mx = fmaxf(mx, s[j]);
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2f(m_run - m_new);
      l_run *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
      m_run = m_new;
#pragma unroll
      for (int j = 0; j < kKeysF32; ++j)
        s[j] = k0 + j < kv ? exp2f(s[j] - m_run) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kKeysF32; ++j) {
      l_run += s[j];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(s[j], vs[j * D + d], acc[d]);
    }
  }

  const int row = q0 + tid;
  if (row < p.sq) {
    const float denom = fmaxf(l_run, kDenomFloor);
    float* orow = og + row * p.o_ss;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / denom;
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32. Strides are in elements; the last dimension of
// every tensor is contiguous. Returns 0, a cudaError_t code, or -1 for a
// head_dim/dtype pair this file has no kernel for.
extern "C" int vpt_short_attention_packed_fwd(
    const void* q, const void* k, const void* v, void* o, const int* kv_lens,
    int batch, int sq, int sk, int heads, int head_dim, long long q_sb,
    long long q_ss, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, long long o_sb, long long o_ss, float scale, int bounded,
    int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kv_lens = kv_lens;
  p.sq = sq;
  p.sk = sk;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.scale_log2 = scale * kLog2e;
  p.bounded = bounded;
  const dim3 grid((sq + kRows - 1) / kRows, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (head_dim == 64)
      return launch(packed_fwd_bf16<64>, p, grid, 128,
                    3 * kRows * (64 + 8) * sizeof(__nv_bfloat16), s);
    if (head_dim == 128)
      return launch(packed_fwd_bf16<128>, p, grid, 128,
                    3 * kRows * (128 + 8) * sizeof(__nv_bfloat16), s);
  } else if (dtype == 1) {
    if (head_dim == 64)
      return launch(packed_fwd_f32<64>, p, grid, kRows,
                    (kRows * 65 + 2 * kKeysF32 * 64) * sizeof(float), s);
    if (head_dim == 128)
      return launch(packed_fwd_f32<128>, p, grid, kRows,
                    (kRows * 129 + 2 * kKeysF32 * 128) * sizeof(float), s);
  }
  return -1;
}
