// The attention forward shared by packed short attention (short_attention.cu)
// and flash attention (flash_attention.cu): one mainloop for both.
//
//   s[i, j]    = q[b, i, h] . k[b, j, h] * scale      (fp32 accumulate)
//   valid      = j < kv_len[b]  (and j <= i when causal)
//   e[i, j]    = exp(s - max_j s)             online softmax (bounded = 0)
//              = exp(clip(s, +-60))           bounded = 1: no running max
//                (0 off the valid set in both modes)
//   o[b, i, h] = sum_j e[i, j] v[b, j, h] / max(sum_j e[i, j], 2^-100)
//   lse[b, h, i] = log(sum_j exp(s[i, j]))    if an LSE buffer is given:
//                  unbounded, -1e30 on a row with no valid key; bounded,
//                  log(max(sum_j e[i, j], 2^-100)), so that the backward's
//                  exp(clip(s) - lse) is e / max(sum e, 2^-100)
//
// over (B, S, H, D)-strided heads read in place (no transposes), with
// kv_lens clamped to Sk. Logits are scaled into the exp2 domain; the weights
// are rounded to v's type before the PV product; o is in the inputs' type.
//
// One thread block owns (64 query rows, head, batch) and carries the whole
// key loop: K and V stream through shared memory in 64-key tiles up to
// kv_len (tiles wholly past kv_len, or wholly above the diagonal when causal,
// are never loaded; K and V are loaded together). bf16 and fp16 inputs (one
// template, T): 4 warps of 16 rows each keep their (16, D) output
// accumulator in registers, run q k^T and p v in mma.sync m16n8k16
// fragments of T with fp32 accumulation (the weights rounded to T), and feed
// the score fragments to the PV product without a trip through shared
// memory; V reaches the tensor cores through ldmatrix.trans. The Q fragments
// are read from shared memory for every key tile, not held in registers:
// fewer registers give more blocks per SM, which hide the unpipelined tile
// loads (0.151 against 0.164 ms at B 64, S 298 and 5.11 against 6.64 ms at
// B 16, S 4106 on an H100, chip_smoke.py --kernels-only). Bounded and causal
// are template parameters. fp32 inputs take a scalar FMA kernel (one thread
// per query row), so that fp32 stays fp32.

#pragma once

#include "attention_common.cuh"

namespace vpt {

constexpr int kFwdRows = 64;     // query rows per block
constexpr int kFwdKeys = 64;     // keys per shared-memory tile, 16-bit kernel
constexpr int kFwdKeysF32 = 16;  // keys per shared-memory tile, fp32 kernel

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;          // (B, H, Sq), or null: no LSE
  const int* kv_lens;  // (B,) or null for "all Sk keys"
  int heads, sq, sk;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh;  // elements
  long long v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale_log2;  // scale * log2(e)
};

// keys [0, end) that some row of the block [q0, q0 + kFwdRows) may attend
template <bool Causal>
__device__ __forceinline__ int fwd_key_end(int kv, int q0) {
  return Causal ? min(kv, q0 + kFwdRows) : kv;
}

template <bool Causal>
__device__ __forceinline__ bool fwd_valid(int kv, int row, int col) {
  return col < kv && (!Causal || col <= row);
}

// m_log2: the running max (0 when bounded), l: the row sum of exp2(s - m)
template <bool Bounded>
__device__ __forceinline__ float fwd_lse(float m_log2, float l) {
  if constexpr (Bounded) return logf(fmaxf(l, kDenomFloor));
  return l > 0.f ? m_log2 * kLn2 + logf(l) : kNegInf;
}

// ------------------------------------------------------- bf16, fp16 / mma

template <typename T, int D, bool Bounded, bool Causal>
__global__ void __launch_bounds__(128) attn_fwd_mma(FwdParams p) {
  constexpr int LD = D + 8, NT = kFwdKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kFwdRows * LD;
  T* vs = ks + kFwdKeys * LD;

  const int q0 = blockIdx.x * kFwdRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
  const int kv = clamped_len(p.kv_lens, b, p.sk);
  const int kend = fwd_key_end<Causal>(kv, q0);
  const float lim = kClip * kLog2e;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_rows16<D>(qs, qg, p.q_ss, q0, kFwdRows, p.sq);

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  // rows r0 and r0 + 8, log2 domain; the bounded mode keeps no max
  const float m0 = Bounded ? 0.f : kNegInf;
  float m_run[2] = {m0, m0};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums

  for (int k0 = 0; k0 < kend; k0 += kFwdKeys) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows2_16<D>(ks, vs, kg, vg, p.k_ss, p.v_ss, k0, kFwdKeys, kv);
    __syncthreads();

    float s[NT][4];
    warp_abt<D, NT>(s, qs, ks, r0, g, t);

    if constexpr (Bounded) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = q0 + r0 + 8 * (e >> 1);
          const float x = fminf(fmaxf(s[j][e] * p.scale_log2, -lim), lim);
          s[j][e] = fwd_valid<Causal>(kv, row, col) ? exp2f(x) : 0.f;
        }
    } else {
      float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = q0 + r0 + 8 * (e >> 1);
          s[j][e] = fwd_valid<Causal>(kv, row, col) ? s[j][e] * p.scale_log2
                                                    : kNegInf;
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[j][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = tile_max[r];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);
        const float alpha = exp2f(m_run[r] - m_new);  // 1 while both -1e30
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
          // masked entries hold -1e30: exactly 0, also where the max is -1e30
          const float x = s[j][e];
          s[j][e] = x > 0.5f * kNegInf ? exp2f(x - m_run[e >> 1]) : 0.f;
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      l_run[0] += s[j][0] + s[j][1];
      l_run[1] += s[j][2] + s[j][3];
    }
    warp_fx<D, NT>(acc, s, vs, lane);
  }

  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = row_sum<4>(l_run[r]);
    const int row = q0 + r0 + 8 * r;
    if (row >= p.sq) continue;
    const float denom = fmaxf(l, kDenomFloor);
    T* orow = og + row * p.o_ss + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8) =
          pack2<T>(acc[dn][2 * r] / denom, acc[dn][2 * r + 1] / denom);
    if (p.lse != nullptr && t == 0)
      p.lse[((long long)b * p.heads + h) * p.sq + row] =
          fwd_lse<Bounded>(m_run[r], l);
  }
}

// ------------------------------------------------------------ fp32 / scalar

template <int D, bool Bounded, bool Causal>
__global__ void __launch_bounds__(kFwdRows) attn_fwd_f32(FwdParams p) {
  constexpr int QLD = D + 1;  // odd stride: row-per-thread reads hit 32 banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kFwdRows * QLD;
  float* vs = ks + kFwdKeysF32 * D;

  const int q0 = blockIdx.x * kFwdRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = q0 + tid;
  const int kv = clamped_len(p.kv_lens, b, p.sk);
  const int kend = fwd_key_end<Causal>(kv, q0);
  const float lim = kClip * kLog2e;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_rows_f32<D>(qs, qg, p.q_ss, q0, kFwdRows, p.sq, QLD);

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m_run = Bounded ? 0.f : kNegInf, l_run = 0.f;
  const float* qrow = qs + tid * QLD;

  for (int k0 = 0; k0 < kend; k0 += kFwdKeysF32) {
    __syncthreads();
    load_rows_f32<D>(ks, kg, p.k_ss, k0, kFwdKeysF32, kv, D);
    load_rows_f32<D>(vs, vg, p.v_ss, k0, kFwdKeysF32, kv, D);
    __syncthreads();

    float s[kFwdKeysF32];
#pragma unroll
    for (int j = 0; j < kFwdKeysF32; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], ks[j * D + d], dot);
      s[j] = dot * p.scale_log2;
    }
    if constexpr (Bounded) {
#pragma unroll
      for (int j = 0; j < kFwdKeysF32; ++j)
        s[j] = fwd_valid<Causal>(kv, row, k0 + j)
                   ? exp2f(fminf(fmaxf(s[j], -lim), lim)) : 0.f;
    } else {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kFwdKeysF32; ++j) {
        if (!fwd_valid<Causal>(kv, row, k0 + j)) s[j] = kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2f(m_run - m_new);
      l_run *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
      m_run = m_new;
#pragma unroll
      for (int j = 0; j < kFwdKeysF32; ++j)
        s[j] = s[j] > 0.5f * kNegInf ? exp2f(s[j] - m_run) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kFwdKeysF32; ++j) {
      l_run += s[j];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(s[j], vs[j * D + d], acc[d]);
    }
  }

  if (row < p.sq) {
    const float denom = fmaxf(l_run, kDenomFloor);
    float* orow = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / denom;
    if (p.lse != nullptr)
      p.lse[((long long)b * p.heads + h) * p.sq + row] =
          fwd_lse<Bounded>(m_run, l_run);
  }
}

// dtype: 0 = bf16, 1 = fp32, 2 = fp16. Returns 0, a cudaError_t code, or -1 for a
// head_dim/dtype pair there is no kernel for. Each caller instantiates only
// the modes it runs.
template <bool Bounded, bool Causal>
int launch_fwd(const FwdParams& p, int batch, int head_dim, int dtype,
               cudaStream_t stream) {
  const dim3 grid((p.sq + kFwdRows - 1) / kFwdRows, p.heads, batch);
  const size_t bf16_row = sizeof(__nv_bfloat16) * (kFwdRows + 2 * kFwdKeys);
  const size_t f32_rows = sizeof(float) * 2 * kFwdKeysF32;
  if (dtype == 0) {
    if (head_dim == 64)
      return launch(attn_fwd_mma<__nv_bfloat16, 64, Bounded, Causal>, p, grid,
                    128, bf16_row * (64 + 8), stream);
    if (head_dim == 128)
      return launch(attn_fwd_mma<__nv_bfloat16, 128, Bounded, Causal>, p, grid,
                    128, bf16_row * (128 + 8), stream);
  } else if (dtype == 2) {
    if (head_dim == 64)
      return launch(attn_fwd_mma<__half, 64, Bounded, Causal>, p, grid, 128,
                    bf16_row * (64 + 8), stream);
    if (head_dim == 128)
      return launch(attn_fwd_mma<__half, 128, Bounded, Causal>, p, grid, 128,
                    bf16_row * (128 + 8), stream);
  } else if (dtype == 1) {
    if (head_dim == 64)
      return launch(attn_fwd_f32<64, Bounded, Causal>, p, grid, kFwdRows,
                    sizeof(float) * kFwdRows * 65 + f32_rows * 64, stream);
    if (head_dim == 128)
      return launch(attn_fwd_f32<128, Bounded, Causal>, p, grid, kFwdRows,
                    sizeof(float) * kFwdRows * 129 + f32_rows * 128, stream);
  }
  return -1;
}

}  // namespace vpt
