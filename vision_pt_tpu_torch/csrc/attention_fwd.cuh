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
// The 16-bit kernel (bf16 and fp16, one template over T) is built from
// Hopper's warpgroup products, TMA and mbarriers (hopper.cuh). One
// warpgroup (128 threads) owns 64 query rows of one (head, batch) and
// carries the whole key loop:
//   - Q is copied once, by cp.async, into a 128-byte-swizzled tile and stays;
//   - K and V tiles of NK keys (128 from Sk 1024 on at D 64, else 64) come
//     by TMA, issued by one thread, into a two-slot ring: the copy of tile
//     j + 1 is in flight during the products of tile j, and its mbarrier
//     says when it has landed. Tiles wholly past kv_len, or wholly above the
//     diagonal when causal, are never loaded; rows past Sk arrive as zeros,
//     and keys at or past kv_len inside a tile get weight exactly 0;
//   - s = Q K^T is a wgmma from shared memory (m64nNK); the softmax works on
//     its accumulator registers, in the exp2 domain, one fma and one SFU
//     exp2 an entry where no entry of the tile is masked; the weights are
//     rounded to T in registers (pack_a) and o += P V is a wgmma with P in
//     registers and V read MN-major from the same swizzled tile (m64nD).
// What bounds it. At the latent shape (B 16, S 4106, H 12, D 64) the two
// products take 0.84 ms at the dense peak, and each logit costs one SFU
// exp2 (3.2e9 of them: 0.8 ms at 16 a cycle an SM) and about five other
// instructions; a warpgroup runs its products and its softmax in turn, and
// the three blocks an SM overlap one another's. On an H100 (700 W) it
// takes 1.9 ms there, against 2.8 for SDPA's flash backend
// (tools/bench/kernel_ab.py). Bounded and causal are template parameters.
// fp32 inputs take a scalar FMA kernel (one thread per query row), so that
// fp32 stays fp32.

#pragma once

#include "hopper.cuh"

namespace vpt {

constexpr int kFwdRows = 64;       // query rows of a block
constexpr int kFwdStages = 2;      // depth of the K/V ring, 16-bit kernel
constexpr int kFwdLongSeq = 1024;  // Sk from which the long key tiles run
constexpr int kFwdKeysShort = 64;  // keys per K/V tile below kFwdLongSeq
constexpr int kFwdKeysLong = 128;  // ... and from it on (D 64)
constexpr int kFwdKeysF32 = 16;    // keys per shared-memory tile, fp32 kernel

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
  // 16-bit kernel: maps over k and v (head_tensor_map), boxes of one key tile
  CUtensorMap k_map, v_map;
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

// ----------------------------------------------------- bf16, fp16 / wgmma

template <typename T, int D, int NK>
constexpr size_t fwd_smem() {
  // the Q tile, the ring of K, V tiles and its mbarriers, slack to align the
  // tiles to 1024 bytes
  return 1024 + (size_t)kFwdRows * D * sizeof(T) +
         (size_t)kFwdStages * 2 * NK * D * sizeof(T) +
         kFwdStages * sizeof(uint64_t);
}

// the softmax of one tile on the accumulator registers of s = Q K^T (this
// thread's s[i]: row rows[(i >> 1) & 1], key k0 + 8 (i >> 2) + 2t + (i & 1)):
// s becomes the unnormalised weights, the running max and this thread's
// partial row sums move on, and alpha is what the output accumulator must be
// multiplied by (1 when bounded). A tile with no entry off the valid set
// (masked false) takes the short path: the max over the raw scores, then
// one fma and one SFU exp2 an entry.
template <int NS, bool Bounded, bool Causal>
__device__ __forceinline__ void fwd_softmax(float (&s)[NS], float (&m_run)[2],
                                            float (&l_run)[2],
                                            float (&alpha)[2], bool masked,
                                            int kv, const int (&rows)[2],
                                            int k0, int t, float scale_log2) {
  auto valid = [&](int i) {
    return fwd_valid<Causal>(kv, rows[(i >> 1) & 1],
                             k0 + 8 * (i >> 2) + 2 * t + (i & 1));
  };
  if constexpr (Bounded) {
    const float lim = kClip * kLog2e;
#pragma unroll
    for (int i = 0; i < NS; ++i)
      s[i] = fast_exp2(fminf(fmaxf(s[i] * scale_log2, -lim), lim));
    if (masked) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (!valid(i)) s[i] = 0.f;
    }
    alpha[0] = alpha[1] = 1.f;
  } else {
    float mx[2] = {kNegInf, kNegInf};
    if (masked) {
      // masked entries hold -1e30 (log2 domain): exactly 0 below, also where
      // the max is -1e30
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = valid(i) ? s[i] * scale_log2 : kNegInf;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
      // max_j round(s_j * c) = round(max_j s_j * c): rounding is monotone
#pragma unroll
      for (int i = 0; i < NS; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      mx[0] *= scale_log2;
      mx[1] *= scale_log2;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = fast_exp2(m_run[r] - m_new);  // 1 while both are -1e30
      l_run[r] *= alpha[r];
      m_run[r] = m_new;
    }
    if (masked) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = s[i] > 0.5f * kNegInf ? fast_exp2(s[i] - m_run[(i >> 1) & 1])
                                     : 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = fast_exp2(fmaf(s[i], scale_log2, -m_run[(i >> 1) & 1]));
    }
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) l_run[(i >> 1) & 1] += s[i];
}

// s = Q K^T of one tile, issued (the caller commits and waits)
template <typename T, int D, int NK>
__device__ __forceinline__ void fwd_scores(float (&s)[NK / 2],
                                           const unsigned char* qs,
                                           const unsigned char* ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, desc_kmajor<kFwdRows>(qs, kk), desc_kmajor<NK>(ks, kk), kk,
             (T*)nullptr);
}

// o += P V of one tile, P in registers, issued (the caller commits and waits)
template <typename T, int D, int NK>
__device__ __forceinline__ void fwd_pv(float (&o)[D / 2],
                                       const uint32_t (&a)[NK / 16][4],
                                       const unsigned char* vs) {
#pragma unroll
  for (int kc = 0; kc < NK / 16; ++kc)
    wgmma_rs(o, a[kc], desc_mnmajor<NK>(vs, kc), 1, (T*)nullptr);
}

template <typename T, int D, int NK, bool Bounded, bool Causal>
__global__ void __launch_bounds__(128)
    attn_fwd_wgmma(const __grid_constant__ FwdParams p) {
  constexpr int QT = kFwdRows * D * sizeof(T), KT = NK * D * sizeof(T);
  constexpr int NS = NK / 2, NO = D / 2;
  extern __shared__ __align__(1024) unsigned char smem_fwd[];
  unsigned char* qs = aligned_smem(smem_fwd);
  unsigned char* ring = qs + QT;  // [kFwdStages][K, V]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kFwdStages * 2 * KT);

  const int q0 = blockIdx.x * kFwdRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv = clamped_len(p.kv_lens, b, p.sk);
  const int ntiles = (fwd_key_end<Causal>(kv, q0) + NK - 1) / NK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kFwdStages; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  cp_async_tile<kFwdRows, D>(qs, qg, p.q_ss, q0, p.sq, 128);
  cp_async_commit();
  __syncthreads();  // the mbarriers are initialised
  // tile j's K and V into slot j % kFwdStages by TMA, one thread, counted on
  // full[slot]; the box's rows past Sk are zeros
  auto issue = [&](int j) {
    if (threadIdx.x == 0 && j < ntiles) {
      unsigned char* slot = ring + (j % kFwdStages) * 2 * KT;
      uint64_t* bar = &full[j % kFwdStages];
      mbar_expect_tx(bar, 2 * KT);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(slot + c * NK * 128, &p.k_map, 64 * c, j * NK, h, b, bar);
        tma_load_4d(slot + KT + c * NK * 128, &p.v_map, 64 * c, j * NK, h, b,
                    bar);
      }
    }
  };
#pragma unroll
  for (int j = 0; j < kFwdStages - 1; ++j) issue(j);

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  // log2 domain; the bounded mode keeps no max
  const float m0 = Bounded ? 0.f : kNegInf;
  float m_run[2] = {m0, m0};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums
  // some entry of the tile from k0 is off the valid set
  auto masked = [&](int k0) {
    return k0 + NK > kv || (Causal && k0 + NK - 1 > q0);
  };

  cp_async_wait<0>();  // Q has landed (the loop's barrier publishes it)
  fence_async_smem();
  float s[NS];
  uint32_t a[NK / 16][4];
  float alpha[2];
  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // every thread is done with slot j - 1; Q is visible
    issue(j + kFwdStages - 1);
    mbar_wait(&full[j % kFwdStages], (j / kFwdStages) & 1);  // tile j
    const int k0 = j * NK;
    const unsigned char* ks = ring + (j % kFwdStages) * 2 * KT;

    pin(s);
    wgmma_fence();
    fwd_scores<T, D, NK>(s, qs, ks);
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    fwd_softmax<NS, Bounded, Causal>(s, m_run, l_run, alpha, masked(k0), kv,
                                     rows, k0, t, p.scale_log2);
    if (!Bounded && (alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int kc = 0; kc < NK / 16; ++kc) pack_a<T>(a[kc], s, kc);
    pin(a);
    pin(o);
    wgmma_fence();
    fwd_pv<T, D, NK>(o, a, ks + KT);
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);
  }
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = row_sum<4>(l_run[r]);
    const int row = rows[r];
    if (row >= p.sq) continue;
    const float denom = fmaxf(l, kDenomFloor);
    T* orow = og + row * p.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack2<T>(o[4 * n + 2 * r] / denom, o[4 * n + 2 * r + 1] / denom);
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

template <typename T, int D, int NK, bool Bounded, bool Causal>
int launch_fwd_wgmma(const FwdParams& params, int batch, cudaStream_t stream) {
  FwdParams p = params;
  if (const cudaError_t err = bind_current_device()) return (int)err;
  if (int rc = head_tensor_map<T>(&p.k_map, p.k, D, p.sk, p.heads, batch,
                                  p.k_sb, p.k_ss, p.k_sh, NK))
    return rc;
  if (int rc = head_tensor_map<T>(&p.v_map, p.v, D, p.sk, p.heads, batch,
                                  p.v_sb, p.v_ss, p.v_sh, NK))
    return rc;
  const dim3 grid((p.sq + kFwdRows - 1) / kFwdRows, p.heads, batch);
  return launch(attn_fwd_wgmma<T, D, NK, Bounded, Causal>, p, grid, 128,
                fwd_smem<T, D, NK>(), stream);
}

// the key tile by Sk and D: 128 keys from Sk 1024 on at D 64, else 64
template <typename T, int D, bool Bounded, bool Causal>
int launch_fwd16(const FwdParams& p, int batch, cudaStream_t stream) {
  if constexpr (D == 64)
    if (p.sk >= kFwdLongSeq)
      return launch_fwd_wgmma<T, D, kFwdKeysLong, Bounded, Causal>(p, batch,
                                                                   stream);
  return launch_fwd_wgmma<T, D, kFwdKeysShort, Bounded, Causal>(p, batch,
                                                                stream);
}

// dtype: 0 = bf16, 1 = fp32, 2 = fp16. Returns 0, a cudaError_t (or, for a
// refused tensor map, CUresult) code, or -1 for a head_dim/dtype pair there
// is no kernel for. Each caller instantiates only the modes it runs.
template <bool Bounded, bool Causal>
int launch_fwd(const FwdParams& p, int batch, int head_dim, int dtype,
               cudaStream_t stream) {
  if (dtype == 0) {
    if (head_dim == 64)
      return launch_fwd16<__nv_bfloat16, 64, Bounded, Causal>(p, batch, stream);
    if (head_dim == 128)
      return launch_fwd16<__nv_bfloat16, 128, Bounded, Causal>(p, batch, stream);
  } else if (dtype == 2) {
    if (head_dim == 64)
      return launch_fwd16<__half, 64, Bounded, Causal>(p, batch, stream);
    if (head_dim == 128)
      return launch_fwd16<__half, 128, Bounded, Causal>(p, batch, stream);
  } else if (dtype == 1) {
    const dim3 grid((p.sq + kFwdRows - 1) / kFwdRows, p.heads, batch);
    const size_t f32_rows = sizeof(float) * 2 * kFwdKeysF32;
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
