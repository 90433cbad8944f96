// Short-sequence attention, backward, for Hopper (sm_90a).
//
// vpt_short_attention_bwd is one C entry for three Pallas TPU kernels of
// vision_pt_tpu/ops/short_attention.py:
//   #2  _bwd_kernel_packed (via _head_bwd), the custom VJP of
//       short_attention_packed: heads are D-wide column slices of (B, S, H*D)
//       tensors, bounded or not;
//   #4  _run_bwd (_bwd_kernel, one (b, h) program) and
//   #6  _run_bwd_ah (_bwd_kernel_ah, all heads of a batch element per
//       program), the custom VJPs of short_attention and short_attention_bhsd:
//       the unbounded function below. Which of the two TPU schedules runs is
//       a VMEM rule of the TPU (_use_all_heads); one entry serves both here.
// Each tensor is read in place through its batch, row and head strides
// (packed and BSHD: head stride D; BHSD: S*D). Per (batch, head):
//
//   s      = q k^T                        (fp32 accumulate)
//   e      = exp2(clip(s * scale * log2e, +-60 * log2e))   bounded=1
//          = exp(s * scale - rowmax)                        bounded=0
//            (0 at key columns >= kv_len in both modes)
//   p      = e / max(sum_j e, 2^-100)     (fp32)
//   dv     = bf16(p)^T do
//   dp     = do v^T                       (fp32)
//   delta  = sum_j p * dp                 (fp32 p and dp, as the TPU kernel)
//   ds     = p * (dp - delta)
//   dq     = bf16(ds) k * scale,  dk = bf16(ds)^T q * scale
//
// outputs in the inputs' type. fp32 inputs keep fp32 throughout.
//
// Bound at the JiT-B/16 256^2 train-step shape (B=64, S=298, H=12, D=64,
// bf16, bounded), on an H100 SXM:
//   bytes  q, k, v, do read and dq, dk, dv written: 7 * 64*298*768*2 B
//          = 205 MB -> 205 MB / 3.35 TB/s = 61 us
//   FLOPs  5 products of 2*B*H*S^2*D = 4.37e10 -> / 989 TFLOP/s = 44 us
// so the kernel is bound by memory, at about 0.061 ms per call. Kernels #4 and
// #6 at the same shape move the same bytes and do the same products: the
// same bound, 0.0612 ms.
//
// Design (simple first). The TPU kernel holds the whole (S, S) fp32 tile of
// one batch element in VMEM and runs the grid in order; here one (S, S) tile
// (355 KB at S=298) does not fit a block's 227 KB of shared memory, and dk/dv
// contract over QUERY rows, which blocks running in no order cannot carry
// between them. So the work splits into two launches, both deterministic (no
// atomics):
//   1. dq kernel, one block per (64 query rows, head, batch): pass 1 streams
//      K/V tiles and gathers the row statistics (running max when unbounded,
//      the row sum and sum_j e*dp), writes (max, denominator, delta) to an
//      fp32 (3, B, H, Sq) scratch; pass 2 streams K/V again and accumulates
//      dq = ds k in mma.sync fragments.
//   2. dk/dv kernel, one block per (64 key rows, head, batch): K/V tile in
//      shared memory, dk and dv in mma.sync fragments; loops over query tiles,
//      recomputing p^T from the saved statistics (scores are computed
//      transposed, s^T = k q^T, so the key rows are the fragment rows and the
//      p^T / ds^T fragments feed the dv / dk products directly).
// Rows past S are loaded as zeros (0 * garbage could be NaN); key rows >=
// kv_len get exactly zero dk, dv; a kv_len == 0 batch row gets zero grads
// (the TPU kernels of #4 and #6 differentiate their uniform weights over the
// padded block there, unbounded; a kept divergence). The head stride is a
// runtime value, one multiply per pointer at a block's start.
// bf16 inputs use mma.sync m16n8k16; fp32 inputs take scalar FMA kernels.
// The TPU kernel's head pairing is not ported: it only fills the TPU's
// 128-deep matrix unit. wgmma, TMA and pipelining are left for later work.

#include "attention_common.cuh"

using namespace vpt;

namespace {

constexpr int kRows = 64;     // query rows (dq kernel) / key rows (dk/dv) per block
constexpr int kTileF32 = 16;  // inner-loop rows per shared-memory tile, fp32
constexpr int kColsF32 = 32;  // columns of a row each thread holds, fp32

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;        // (3, B, H, Sq): row max (log2 domain), denom, delta
  const int* kv_lens;  // (B,) or null for "all Sk keys"
  int heads, sq, sk;
  // batch, row and head strides, in elements
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  long long plane;   // B * H * Sq, the stride between the three statistics
  float scale;       // softmax scale
  float scale_log2;  // scale * log2(e)
  int bounded;
};

__device__ __forceinline__ float clipped_exp2(float x) {
  const float lim = kClip * kLog2e;
  return exp2f(fminf(fmaxf(x, -lim), lim));
}

// out (16 x D) += bf16(f) (16 x 8NT, C fragments) times the first 8NT rows
// of `xs` ((rows, D) in shared memory), B built from 16-bit shared loads.
// The header's warp_fx (ldmatrix.trans) computes the same; here it raised the
// dk/dv kernel to 186 registers and the backward from 1.07 to 1.26 ms at
// B 64, S 298 (H100, chip_smoke.py), so this kernel keeps its own.
template <int D, int NT>
__device__ __forceinline__ void warp_fx_u16(float out[D / 8][4],
                                            const float f[NT][4],
                                            const __nv_bfloat16* xs, int g,
                                            int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    const uint32_t fa[4] = {
        pack_bf16(f[2 * kc][0], f[2 * kc][1]),
        pack_bf16(f[2 * kc][2], f[2 * kc][3]),
        pack_bf16(f[2 * kc + 1][0], f[2 * kc + 1][1]),
        pack_bf16(f[2 * kc + 1][2], f[2 * kc + 1][3]),
    };
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const __nv_bfloat16* xb = xs + (kc * 16 + 2 * t) * LD + dn * 8 + g;
      mma_bf16_16816(out[dn], fa, pack_raw(xb[0], xb[LD]),
                     pack_raw(xb[8 * LD], xb[9 * LD]));
    }
  }
}

// ---------------------------------------------------------------- bf16 / mma

template <int D, int KT>
__global__ void __launch_bounds__(128) packed_bwd_dq_bf16(BwdParams p) {
  constexpr int LD = D + 8, NT = KT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kRows * LD;
  __nv_bfloat16* ks = dos + kRows * LD;
  __nv_bfloat16* vs = ks + KT * LD;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;
  const int kv = clamped_len(p.kv_lens, b, p.sk);

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dog =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;

  load_rows2_bf16<D>(qs, dos, qg, dog, p.q_ss, p.do_ss, q0, kRows, p.sq);

  // pass 1: row statistics (this thread's partial sums of rows g, g + 8)
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float d_run[2] = {0.f, 0.f};  // sum_j e * dp
  for (int k0 = 0; k0 < kv; k0 += KT) {
    __syncthreads();
    load_rows2_bf16<D>(ks, vs, kg, vg, p.k_ss, p.v_ss, k0, KT, kv);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    warp_abt<D, NT>(s, qs, ks, r0, g, t);
    warp_abt<D, NT>(dp, dos, vs, r0, g, t);
    if (p.bounded) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const float x = col < kv ? clipped_exp2(s[j][e] * p.scale_log2) : 0.f;
          l_run[e >> 1] += x;
          d_run[e >> 1] += x * dp[j][e];
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
        d_run[r] *= alpha;
        m_run[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const float x = col < kv ? exp2f(s[j][e] - m_run[e >> 1]) : 0.f;
          l_run[e >> 1] += x;
          d_run[e >> 1] += x * dp[j][e];
        }
    }
  }
  float mrow[2], denom[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r], d = d_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    denom[r] = fmaxf(l, kDenomFloor);
    delta[r] = d / denom[r];
    mrow[r] = p.bounded ? 0.f : m_run[r];
    const int row = q0 + r0 + 8 * r;
    if (t == 0 && row < p.sq) {
      float* st = p.stats + ((long long)b * p.heads + h) * p.sq + row;
      st[0] = mrow[r];
      st[p.plane] = denom[r];
      st[2 * p.plane] = delta[r];
    }
  }

  // pass 2: dq = ds k
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  for (int k0 = 0; k0 < kv; k0 += KT) {
    __syncthreads();
    load_rows2_bf16<D>(ks, vs, kg, vg, p.k_ss, p.v_ss, k0, KT, kv);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    warp_abt<D, NT>(s, qs, ks, r0, g, t);
    warp_abt<D, NT>(dp, dos, vs, r0, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const float x = s[j][e] * p.scale_log2;
        const float ex = p.bounded ? clipped_exp2(x) : exp2f(x - mrow[r]);
        const float pr = col < kv ? ex / denom[r] : 0.f;
        s[j][e] = pr * (dp[j][e] - delta[r]);  // ds
      }
    warp_fx_u16<D, NT>(acc, s, ks, g, t);
  }
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows_bf16<D>(dqg, p.dq_ss, acc, q0 + r0, p.sq, p.scale, t);
}

template <int D, int QT>
__global__ void __launch_bounds__(128) packed_bwd_dkdv_bf16(BwdParams p) {
  constexpr int LD = D + 8, NQ = QT / 8, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kRows * LD;
  __nv_bfloat16* qs = vs + kRows * LD;
  __nv_bfloat16* dos = qs + QT * LD;
  float* st_m = reinterpret_cast<float*>(dos + QT * LD);
  float* st_d = st_m + QT;
  float* st_delta = st_d + QT;

  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;
  const int kv = clamped_len(p.kv_lens, b, p.sk);

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  if (k0 >= kv) {  // every key of the tile is masked: zero grads
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < kRows * CH; i += blockDim.x) {
      const int row = k0 + i / CH, c = i % CH;
      if (row >= p.sk) continue;
      *reinterpret_cast<uint4*>(dkg + row * p.dk_ss + c * 8) = zero;
      *reinterpret_cast<uint4*>(dvg + row * p.dv_ss + c * 8) = zero;
    }
    return;
  }

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dog =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* st = p.stats + ((long long)b * p.heads + h) * p.sq;

  load_rows2_bf16<D>(ks, vs, kg, vg, p.k_ss, p.v_ss, k0, kRows, kv);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  for (int q0 = 0; q0 < p.sq; q0 += QT) {
    __syncthreads();
    load_rows2_bf16<D>(qs, dos, qg, dog, p.q_ss, p.do_ss, q0, QT, p.sq);
    for (int i = threadIdx.x; i < QT; i += blockDim.x) {
      const bool in = q0 + i < p.sq;
      st_m[i] = in ? st[q0 + i] : 0.f;
      st_d[i] = in ? st[p.plane + q0 + i] : 1.f;
      st_delta[i] = in ? st[2 * p.plane + q0 + i] : 0.f;
    }
    __syncthreads();
    float s[NQ][4], dp[NQ][4];  // s^T = k q^T, dp^T = v do^T
    warp_abt<D, NQ>(s, ks, qs, r0, g, t);
    warp_abt<D, NQ>(dp, vs, dos, r0, g, t);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + r0 + 8 * (e >> 1);
        const int qi = j * 8 + 2 * t + (e & 1);
        const float x = s[j][e] * p.scale_log2;
        const float ex = p.bounded ? clipped_exp2(x) : exp2f(x - st_m[qi]);
        const float pr = (key < kv && q0 + qi < p.sq) ? ex / st_d[qi] : 0.f;
        s[j][e] = pr;                               // p^T
        dp[j][e] = pr * (dp[j][e] - st_delta[qi]);  // ds^T
      }
    warp_fx_u16<D, NQ>(dv, s, dos, g, t);
    warp_fx_u16<D, NQ>(dk, dp, qs, g, t);
  }
  store_rows_bf16<D>(dkg, p.dk_ss, dk, k0 + r0, p.sk, p.scale, t);
  store_rows_bf16<D>(dvg, p.dv_ss, dv, k0 + r0, p.sk, 1.f, t);
}

// ------------------------------------------------------------ fp32 / scalar
//
// D / 32 adjacent threads share a row: each holds 32 of its D columns and
// the partial dot products are summed with shuffles.

template <int D>
__global__ void __launch_bounds__(kRows * (D / kColsF32)) packed_bwd_dq_f32(BwdParams p) {
  constexpr int P = D / kColsF32, QLD = D + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kRows * QLD;
  float* ks = dos + kRows * QLD;
  float* vs = ks + kTileF32 * D;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rl = tid / P;
  const int c0 = (tid % P) * kColsF32;
  const int kv = clamped_len(p.kv_lens, b, p.sk);

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;

  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < p.sq;
    qs[r * QLD + c] = in ? qg[(q0 + r) * p.q_ss + c] : 0.f;
    dos[r * QLD + c] = in ? dog[(q0 + r) * p.do_ss + c] : 0.f;
  }
  const float* qrow = qs + rl * QLD + c0;
  const float* dorow = dos + rl * QLD + c0;

  float m_run = kNegInf, l_run = 0.f, d_run = 0.f;
  for (int k0 = 0; k0 < kv; k0 += kTileF32) {
    __syncthreads();
    for (int i = tid; i < kTileF32 * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < kv;
      ks[i] = in ? kg[(k0 + r) * p.k_ss + c] : 0.f;
      vs[i] = in ? vg[(k0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();
    float s[kTileF32], dp[kTileF32];
#pragma unroll
    for (int j = 0; j < kTileF32; ++j) {
      float sd = 0.f, pd = 0.f;
#pragma unroll
      for (int d = 0; d < kColsF32; ++d) {
        sd = fmaf(qrow[d], ks[j * D + c0 + d], sd);
        pd = fmaf(dorow[d], vs[j * D + c0 + d], pd);
      }
      s[j] = row_sum<P>(sd) * p.scale_log2;
      dp[j] = row_sum<P>(pd);
    }
    if (p.bounded) {
#pragma unroll
      for (int j = 0; j < kTileF32; ++j) {
        const float x = k0 + j < kv ? clipped_exp2(s[j]) : 0.f;
        l_run += x;
        d_run += x * dp[j];
      }
    } else {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kTileF32; ++j)
        if (k0 + j < kv) mx = fmaxf(mx, s[j]);
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2f(m_run - m_new);
      l_run *= alpha;
      d_run *= alpha;
      m_run = m_new;
#pragma unroll
      for (int j = 0; j < kTileF32; ++j) {
        const float x = k0 + j < kv ? exp2f(s[j] - m_run) : 0.f;
        l_run += x;
        d_run += x * dp[j];
      }
    }
  }
  const float denom = fmaxf(l_run, kDenomFloor);
  const float delta = d_run / denom;
  const float mrow = p.bounded ? 0.f : m_run;
  const int row = q0 + rl;
  if (c0 == 0 && row < p.sq) {
    float* st = p.stats + ((long long)b * p.heads + h) * p.sq + row;
    st[0] = mrow;
    st[p.plane] = denom;
    st[2 * p.plane] = delta;
  }

  float acc[kColsF32];
#pragma unroll
  for (int d = 0; d < kColsF32; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < kv; k0 += kTileF32) {
    __syncthreads();
    for (int i = tid; i < kTileF32 * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < kv;
      ks[i] = in ? kg[(k0 + r) * p.k_ss + c] : 0.f;
      vs[i] = in ? vg[(k0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kTileF32; ++j) {
      float sd = 0.f, pd = 0.f;
#pragma unroll
      for (int d = 0; d < kColsF32; ++d) {
        sd = fmaf(qrow[d], ks[j * D + c0 + d], sd);
        pd = fmaf(dorow[d], vs[j * D + c0 + d], pd);
      }
      const float x = row_sum<P>(sd) * p.scale_log2;
      const float ex = p.bounded ? clipped_exp2(x) : exp2f(x - mrow);
      const float pr = k0 + j < kv ? ex / denom : 0.f;
      const float ds = pr * (row_sum<P>(pd) - delta);
#pragma unroll
      for (int d = 0; d < kColsF32; ++d) acc[d] = fmaf(ds, ks[j * D + c0 + d], acc[d]);
    }
  }
  if (row < p.sq) {
    float* out = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh + row * p.dq_ss + c0;
#pragma unroll
    for (int d = 0; d < kColsF32; ++d) out[d] = acc[d] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kRows * (D / kColsF32)) packed_bwd_dkdv_f32(BwdParams p) {
  constexpr int P = D / kColsF32, QLD = D + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kRows * QLD;
  float* qs = vs + kRows * QLD;
  float* dos = qs + kTileF32 * D;
  float* st_m = dos + kTileF32 * D;
  float* st_d = st_m + kTileF32;
  float* st_delta = st_d + kTileF32;

  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rl = tid / P;
  const int c0 = (tid % P) * kColsF32;
  const int kv = clamped_len(p.kv_lens, b, p.sk);
  const int key = k0 + rl;

  float* dkg = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  float* dvg = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  if (k0 >= kv) {  // every key of the tile is masked: zero grads
    if (key < p.sk) {
#pragma unroll
      for (int d = 0; d < kColsF32; ++d) {
        dkg[key * p.dk_ss + c0 + d] = 0.f;
        dvg[key * p.dv_ss + c0 + d] = 0.f;
      }
    }
    return;
  }

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* st = p.stats + ((long long)b * p.heads + h) * p.sq;

  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < kv;
    ks[r * QLD + c] = in ? kg[(k0 + r) * p.k_ss + c] : 0.f;
    vs[r * QLD + c] = in ? vg[(k0 + r) * p.v_ss + c] : 0.f;
  }
  const float* krow = ks + rl * QLD + c0;
  const float* vrow = vs + rl * QLD + c0;

  float dk[kColsF32], dv[kColsF32];
#pragma unroll
  for (int d = 0; d < kColsF32; ++d) dk[d] = dv[d] = 0.f;
  for (int q0 = 0; q0 < p.sq; q0 += kTileF32) {
    __syncthreads();
    for (int i = tid; i < kTileF32 * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = q0 + r < p.sq;
      qs[i] = in ? qg[(q0 + r) * p.q_ss + c] : 0.f;
      dos[i] = in ? dog[(q0 + r) * p.do_ss + c] : 0.f;
    }
    for (int i = tid; i < kTileF32; i += blockDim.x) {
      const bool in = q0 + i < p.sq;
      st_m[i] = in ? st[q0 + i] : 0.f;
      st_d[i] = in ? st[p.plane + q0 + i] : 1.f;
      st_delta[i] = in ? st[2 * p.plane + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < kTileF32; ++i) {
      float sd = 0.f, pd = 0.f;
#pragma unroll
      for (int d = 0; d < kColsF32; ++d) {
        sd = fmaf(krow[d], qs[i * D + c0 + d], sd);
        pd = fmaf(vrow[d], dos[i * D + c0 + d], pd);
      }
      const float x = row_sum<P>(sd) * p.scale_log2;
      const float ex = p.bounded ? clipped_exp2(x) : exp2f(x - st_m[i]);
      const float pr = (key < kv && q0 + i < p.sq) ? ex / st_d[i] : 0.f;
      const float ds = pr * (row_sum<P>(pd) - st_delta[i]);
#pragma unroll
      for (int d = 0; d < kColsF32; ++d) {
        dv[d] = fmaf(pr, dos[i * D + c0 + d], dv[d]);
        dk[d] = fmaf(ds, qs[i * D + c0 + d], dk[d]);
      }
    }
  }
  if (key < p.sk) {
#pragma unroll
    for (int d = 0; d < kColsF32; ++d) {
      dkg[key * p.dk_ss + c0 + d] = dk[d] * p.scale;
      dvg[key * p.dv_ss + c0 + d] = dv[d];
    }
  }
}

template <typename DqKernel, typename DkdvKernel>
int launch_pair(DqKernel dq_kernel, DkdvKernel dkdv_kernel, const BwdParams& p,
                int batch, int threads, size_t dq_smem, size_t dkdv_smem,
                cudaStream_t stream) {
  const dim3 dq_grid((p.sq + kRows - 1) / kRows, p.heads, batch);
  int rc = launch(dq_kernel, p, dq_grid, threads, dq_smem, stream);
  if (rc != 0) return rc;
  const dim3 dkdv_grid((p.sk + kRows - 1) / kRows, p.heads, batch);
  return launch(dkdv_kernel, p, dkdv_grid, threads, dkdv_smem, stream);
}

constexpr size_t bf16_smem(int d, int inner) {
  return (2 * kRows + 2 * inner) * (d + 8) * sizeof(__nv_bfloat16);
}

// Launches the dq kernel, then the dk/dv kernel, for p's dtype (0 = bf16,
// 1 = fp32) and head_dim. Returns 0, a cudaError_t code, or -1 for a
// head_dim/dtype pair this file has no kernel for.
int run_bwd(BwdParams& p, int batch, int head_dim, int dtype, float scale,
            int bounded, float* stats, cudaStream_t s) {
  p.stats = stats;
  p.plane = (long long)batch * p.heads * p.sq;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.bounded = bounded;
  constexpr size_t stats_smem = 3 * 64 * sizeof(float);
  if (dtype == 0) {
    if (head_dim == 64)
      return launch_pair(packed_bwd_dq_bf16<64, 64>, packed_bwd_dkdv_bf16<64, 64>,
                         p, batch, 128, bf16_smem(64, 64),
                         bf16_smem(64, 64) + stats_smem, s);
    if (head_dim == 128)
      return launch_pair(packed_bwd_dq_bf16<128, 32>,
                         packed_bwd_dkdv_bf16<128, 32>, p, batch, 128,
                         bf16_smem(128, 32), bf16_smem(128, 32) + stats_smem, s);
  } else if (dtype == 1) {
    const size_t rows = 2 * kRows, tile = 2 * kTileF32;
    if (head_dim == 64)
      return launch_pair(packed_bwd_dq_f32<64>, packed_bwd_dkdv_f32<64>, p,
                         batch, kRows * 64 / kColsF32,
                         (rows * 65 + tile * 64) * sizeof(float),
                         (rows * 65 + tile * 64 + 3 * kTileF32) * sizeof(float), s);
    if (head_dim == 128)
      return launch_pair(packed_bwd_dq_f32<128>, packed_bwd_dkdv_f32<128>, p,
                         batch, kRows * 128 / kColsF32,
                         (rows * 129 + tile * 128) * sizeof(float),
                         (rows * 129 + tile * 128 + 3 * kTileF32) * sizeof(float),
                         s);
  }
  return -1;
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32. `strides` holds (batch, row, head) strides in
// elements for q, k, v, dout, dq, dk, dv in that order (21 values); the last
// dimension of every tensor is contiguous. `stats` is fp32 scratch of
// 3 * B * H * Sq. Launches the dq kernel, then the dk/dv kernel, on `stream`.
// Returns 0, a cudaError_t code, or -1 for a head_dim/dtype pair this file
// has no kernel for.
extern "C" int vpt_short_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, float* stats, const int* kv_lens, int batch, int sq,
    int sk, int heads, int head_dim, const long long* strides, float scale,
    int bounded, int dtype, void* stream) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.kv_lens = kv_lens;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  long long* fields[7][3] = {
      {&p.q_sb, &p.q_ss, &p.q_sh},    {&p.k_sb, &p.k_ss, &p.k_sh},
      {&p.v_sb, &p.v_ss, &p.v_sh},    {&p.do_sb, &p.do_ss, &p.do_sh},
      {&p.dq_sb, &p.dq_ss, &p.dq_sh}, {&p.dk_sb, &p.dk_ss, &p.dk_sh},
      {&p.dv_sb, &p.dv_ss, &p.dv_sh}};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) *fields[i][j] = strides[3 * i + j];
  return run_bwd(p, batch, head_dim, dtype, scale, bounded, stats,
                 static_cast<cudaStream_t>(stream));
}
