// The 16-bit attention backward shared by packed short attention
// (short_attention_bwd.cu: #2, #4, #6) and flash attention
// (flash_attention_bwd.cu: #8): one pair of warpgroup kernels for both.
// Per (batch, head), over (B, S, H, D)-strided tensors read in place:
//
//   x      = q k^T * scale * log2e           (fp32 accumulate)
//            clipped to +-60 * log2e when bounded
//   p      = exp2(x - lse * log2e)           on the valid set, else 0
//            (valid: key < kv_len, and key <= row when causal), with lse the
//            forward's row log-sum-exp, so p is the forward's weights
//   dv     = T(p)^T do
//   dp     = do v^T                          (fp32)
//   ds     = p * (dp - delta)
//   dq     = T(ds) k * scale,  dk = T(ds)^T q * scale
//
// with T the inputs' type (bf16 or fp16); outputs in T. The template
// parameter Rowsum picks the arithmetic of the JAX function replaced:
//   false (#2/#4/#6): delta = sum_j p * dp, the TPU kernel's own, from a
//     first sweep of the dq kernel over the key tiles (rowsum(do * o) misses
//     the tests' bf16 limit there: tests/test_torch_short_attention_delta.py);
//     the scale multiplies the fp32 sums of dq and dk;
//   true (#8): delta = sum_d do * o in fp32 from the stored o, as the JAX
//     function takes it, and one sweep; the scale is folded into ds before
//     its rounding to T.
// Either way the dq kernel writes delta to plane 0 of the fp32 scratch
// `stats`, which the dk/dv kernel reads.
//
// Blocks run in no order and may not add into one sum (no fp32 atomics:
// repeated calls give the same bits), so two launches on one stream, one
// warpgroup (128 threads) a block:
//   1. dq kernel, one block per (64 query rows, head, batch): Q and dO stay
//      in 128-byte-swizzled shared-memory tiles (cp.async); K/V tiles of NT
//      keys (64 at D 64, 32 at D 128), up to kv_len (the diagonal when
//      causal), come by TMA into a ring of kBwdDqStages slots, the copy of
//      the next tile in flight during the products of this one; s = Q K^T
//      and dp = dO V^T are wgmma from shared memory, ds is formed in the
//      accumulator registers, and dq += T(ds) K is a wgmma with ds in
//      registers and K read MN-major from the same tile.
//   2. dk/dv kernel, one block per (64 key rows, head, batch): K and V stay,
//      Q/dO tiles (TMA) with their lse and delta (cp.async) stream through
//      a ring of kBwdDkdvStages slots (from the diagonal on when causal);
//      s^T = K Q^T and
//      dp^T = V dO^T (the key rows are the wgmma rows), then dv += T(p^T) dO
//      and dk += T(ds^T) Q with p^T and ds^T in registers. A key tile wholly
//      past kv_len writes zeros and stops.
// Each weight is one SFU exp2 of an fma (fast_exp2); the valid set is
// checked entry by entry (a second, unchecked copy of the loop for tiles
// with nothing masked measured slower, tools/bench/kernel_ab.py).
// 7 (S, S, D) products a call for rowsum (s and dp in both kernels), 9 with
// the sweep, against the function's 5: dq and dk contract over different
// axes. Rows past S are loaded as zeros; key rows >= kv_len get exactly
// zero dk, dv; a kv_len == 0 batch row gets zero gradients.

#pragma once

#include "hopper.cuh"

namespace vpt {

constexpr int kBwdRows = 64;      // query rows (dq) / key rows (dk/dv) a block
constexpr int kBwdThreads = 128;  // one warpgroup
constexpr int kBwdDqStages = 2;   // the dq kernel's K/V ring: 49 KB a block at
                                  // D 64, four blocks an SM
constexpr int kBwdDkdvStages = 3; // the dk/dv kernel's Q/dO ring

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;       // the forward's output (#8's delta), or null
  const void* dout;
  const float* lse;    // (B, H, Sq), natural log, from the forward
  void* dq;
  void* dk;
  void* dv;
  // fp32 scratch, planes of B * H * Sq: the 16-bit kernels' delta in plane
  // 0 (and #8's fp32 kernels'); #2's fp32 kernels keep the row max (log2
  // domain), denominator and delta in planes 0-2
  float* stats;
  const int* kv_lens;  // (B,) or null for "all Sk keys"
  int heads, sq, sk;
  // batch, row and head strides, in elements
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  long long plane;   // B * H * Sq, the stride between the statistics
  float scale;       // softmax scale
  float scale_log2;  // scale * log2(e)
  int bounded;
  int causal;
  // 16-bit kernels: maps (head_tensor_map) over k, v (the dq kernel's ring)
  // and q, dout (the dk/dv kernel's), boxes of one inner tile
  CUtensorMap k_map, v_map, q_map, do_map;
};

__device__ __forceinline__ long long stat_offset(const BwdParams& p, int b,
                                                 int h) {
  return ((long long)b * p.heads + h) * p.sq;
}

// the forward's weight exp2(x - lse2) of a score s, with x the logit in the
// exp2 domain (clipped when bounded) and lse2 = lse * log2e
template <bool Bounded>
__device__ __forceinline__ float bwd_weight(float s, float scale_log2,
                                            float lse2) {
  if constexpr (Bounded) {
    const float lim = kClip * kLog2e;
    return fast_exp2(fminf(fmaxf(s * scale_log2, -lim), lim) - lse2);
  }
  return fast_exp2(fmaf(s, scale_log2, -lse2));
}

template <typename T, int D, int NT>
constexpr size_t bwd_dq_smem() {
  constexpr int STAGES = kBwdDqStages;
  // Q, dO; the ring of K, V tiles and its mbarriers; slack to align the
  // tiles to 1024 bytes
  return 1024 + 2 * kBwdRows * D * sizeof(T) + STAGES * 2 * NT * D * sizeof(T) +
         STAGES * sizeof(uint64_t);
}

template <typename T, int D, int NT>
constexpr size_t bwd_dkdv_smem() {
  constexpr int STAGES = kBwdDkdvStages;
  // K, V; the ring of Q, dO tiles, of their lse and delta, and its
  // mbarriers; slack
  return 1024 + 2 * kBwdRows * D * sizeof(T) + STAGES * 2 * NT * D * sizeof(T) +
         STAGES * 2 * NT * sizeof(float) + STAGES * sizeof(uint64_t);
}

// s (+)= A B^T and dp (+)= C D^T over the D / 16 k16 steps of four swizzled
// tiles (A, C: 64 rows; B, D: NT rows), then wait for both
template <typename T, int D, int NT>
__device__ __forceinline__ void two_products(float (&s)[NT / 2],
                                             float (&dp)[NT / 2],
                                             const unsigned char* a,
                                             const unsigned char* b,
                                             const unsigned char* c,
                                             const unsigned char* d) {
  pin(s);
  pin(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, desc_kmajor<kBwdRows>(a, kk), desc_kmajor<NT>(b, kk), kk,
             (T*)nullptr);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(dp, desc_kmajor<kBwdRows>(c, kk), desc_kmajor<NT>(d, kk), kk,
             (T*)nullptr);
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
  pin(dp);
}

// delta of rows r0 and r0 + 8 (r0 = warp * 16 + g of the block's rows from
// q0): sum_d do * o in fp32, each of the 4 threads of a row over D / 4
// columns, summed across them; written to plane 0 of the scratch
template <typename T, int D>
__device__ __forceinline__ void rowsum_delta(float (&delta)[2],
                                             const BwdParams& p, int b, int h,
                                             int q0, const int (&rr)[2],
                                             int t) {
  constexpr int C = D / 4;
  const T* og = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rr[r];
    float d = 0.f;
    if (row < p.sq) {
#pragma unroll
      for (int c = 0; c < C; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(og + row * p.o_ss + t * C + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dog + row * p.do_ss + t * C + c);
        const T* oe = reinterpret_cast<const T*>(&ov);
        const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(to_float(de[e]), to_float(oe[e]), d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    delta[r] = d;
    if (t == 0 && row < p.sq) p.stats[stat_offset(p, b, h) + row] = d;
  }
}

template <typename T, int D, int NT, bool Rowsum, bool Bounded, bool Causal>
__global__ void __launch_bounds__(kBwdThreads)
    attn_bwd_dq_wgmma(const __grid_constant__ BwdParams p) {
  constexpr bool Sweep = !Rowsum;
  constexpr int STAGES = kBwdDqStages;
  constexpr int TILE = NT * D * sizeof(T), QT = kBwdRows * D * sizeof(T);
  extern __shared__ __align__(1024) unsigned char smem_bwd[];
  unsigned char* qs = aligned_smem(smem_bwd);
  unsigned char* dos = qs + QT;
  unsigned char* ring = dos + QT;  // [STAGES][K, V]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * TILE);

  const int q0 = blockIdx.x * kBwdRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv = clamped_len(p.kv_lens, b, p.sk);
  const int ntiles = ((Causal ? min(kv, q0 + kBwdRows) : kv) + NT - 1) / NT;
  const int steps = Sweep ? 2 * ntiles : ntiles;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long st = stat_offset(p, b, h);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  cp_async_tile<kBwdRows, D>(qs, qg, p.q_ss, q0, p.sq, kBwdThreads);
  cp_async_tile<kBwdRows, D>(dos, dog, p.do_ss, q0, p.sq, kBwdThreads);
  cp_async_commit();
  __syncthreads();  // the mbarriers are initialised
  // step j: key tile j (with Sweep, the first sweep over tile j < ntiles,
  // then the second over tile j - ntiles) into slot j % STAGES by TMA, one
  // thread, counted on full[slot]
  auto issue = [&](int j) {
    if (threadIdx.x == 0 && j < steps) {
      const int k0 = (Sweep && j >= ntiles ? j - ntiles : j) * NT;
      unsigned char* slot = ring + (j % STAGES) * 2 * TILE;
      uint64_t* bar = &full[j % STAGES];
      mbar_expect_tx(bar, 2 * TILE);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(slot + c * NT * 128, &p.k_map, 64 * c, k0, h, b, bar);
        tma_load_4d(slot + TILE + c * NT * 128, &p.v_map, 64 * c, k0, h, b,
                    bar);
      }
    }
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);

  const int rr[2] = {warp * 16 + g, warp * 16 + g + 8};
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse2[r] = q0 + rr[r] < p.sq ? p.lse[st + q0 + rr[r]] * kLog2e : 0.f;

  // Sweep: this thread's partial sums, then the rows'; rowsum: the rows'
  float delta[2] = {0.f, 0.f};
  if constexpr (!Sweep) rowsum_delta<T, D>(delta, p, b, h, q0, rr, t);
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  cp_async_wait<0>();  // Q and dO have landed
  fence_async_smem();
  for (int j = 0; j < steps; ++j) {
    __syncthreads();  // Q/dO for every thread; slot j - 1 is free
    issue(j + STAGES - 1);
    mbar_wait(&full[j % STAGES], (j / STAGES) & 1);  // step j's tile
    const bool second = !Sweep || j >= ntiles;
    const int k0 = (Sweep && j >= ntiles ? j - ntiles : j) * NT;
    const unsigned char* ks = ring + (j % STAGES) * 2 * TILE;
    const unsigned char* vs = ks + TILE;

    float s[NT / 2], dp[NT / 2];
    two_products<T, D, NT>(s, dp, qs, ks, dos, vs);

    if (Sweep && j == ntiles) {  // the first sweep is done: whole-row delta
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
        if (t == 0 && q0 + rr[r] < p.sq) p.stats[st + q0 + rr[r]] = delta[r];
      }
    }
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
      const int r = (i >> 1) & 1;
      const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      const bool valid = col < kv && (!Causal || col <= q0 + rr[r]);
      const float pr =
          valid ? bwd_weight<Bounded>(s[i], p.scale_log2, lse2[r]) : 0.f;
      if (second)
        s[i] = Rowsum ? pr * (dp[i] - delta[r]) * p.scale  // ds
                      : pr * (dp[i] - delta[r]);
      else
        delta[r] = fmaf(pr, dp[i], delta[r]);
    }
    if (!second) continue;
    uint32_t a[NT / 16][4];
#pragma unroll
    for (int kc = 0; kc < NT / 16; ++kc) pack_a<T>(a[kc], s, kc);
    pin(a);
    pin(dq);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < NT / 16; ++kc)
      wgmma_rs(dq, a[kc], desc_mnmajor<NT>(ks, kc), 1, (T*)nullptr);
    wgmma_commit();
    wgmma_wait<0>();
    pin(dq);
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const float out_scale = Rowsum ? 1.f : p.scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rr[r];
    if (row >= p.sq) continue;
    T* out = dqg + row * p.dq_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          pack2<T>(dq[4 * n + 2 * r] * out_scale,
                   dq[4 * n + 2 * r + 1] * out_scale);
  }
}

template <typename T, int D, int NT, bool Rowsum, bool Bounded, bool Causal>
__global__ void __launch_bounds__(kBwdThreads)
    attn_bwd_dkdv_wgmma(const __grid_constant__ BwdParams p) {
  constexpr int STAGES = kBwdDkdvStages;
  constexpr int TILE = NT * D * sizeof(T), KT = kBwdRows * D * sizeof(T);
  constexpr int CH = D / 8;
  extern __shared__ __align__(1024) unsigned char smem_bwd[];
  unsigned char* ks = aligned_smem(smem_bwd);
  unsigned char* vs = ks + KT;
  unsigned char* ring = vs + KT;  // [STAGES][Q, dO]
  // [STAGES][lse, delta][NT]
  float* rows_ring = reinterpret_cast<float*>(ring + STAGES * 2 * TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows_ring + STAGES * 2 * NT);

  const int k0 = blockIdx.x * kBwdRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv = clamped_len(p.kv_lens, b, p.sk);

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  if (k0 >= kv) {  // every key of the tile is masked: zero grads
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < kBwdRows * CH; i += kBwdThreads) {
      const int row = k0 + i / CH, c = i % CH;
      if (row >= p.sk) continue;
      *reinterpret_cast<uint4*>(dkg + row * p.dk_ss + c * 8) = zero;
      *reinterpret_cast<uint4*>(dvg + row * p.dv_ss + c * 8) = zero;
    }
    return;
  }

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const long long st = stat_offset(p, b, h);
  // causal: query rows below k0 attend no key of this block (NT divides 64)
  const int first = Causal ? k0 / NT : 0;
  const int ntiles = (p.sq + NT - 1) / NT - first;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  cp_async_tile<kBwdRows, D>(ks, kg, p.k_ss, k0, kv, kBwdThreads);
  cp_async_tile<kBwdRows, D>(vs, vg, p.v_ss, k0, kv, kBwdThreads);
  cp_async_commit();
  __syncthreads();  // the mbarriers are initialised
  // query tile first + i into its slot: Q and dO by TMA, one thread,
  // counted on full[slot]; their lse and delta by cp.async, every thread,
  // one group a tile (empty past the end)
  auto issue = [&](int i) {
    if (i < ntiles) {
      const int slot = i % STAGES, q0 = (first + i) * NT;
      if (threadIdx.x == 0) {
        unsigned char* tiles = ring + slot * 2 * TILE;
        uint64_t* bar = &full[slot];
        mbar_expect_tx(bar, 2 * TILE);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(tiles + c * NT * 128, &p.q_map, 64 * c, q0, h, b, bar);
          tma_load_4d(tiles + TILE + c * NT * 128, &p.do_map, 64 * c, q0, h, b,
                      bar);
        }
      }
      float* rows = rows_ring + slot * 2 * NT;
      for (int r = threadIdx.x; r < 2 * NT; r += kBwdThreads) {
        const int row = q0 + (r % NT);
        const bool ok = row < p.sq;
        const float* src = r < NT ? p.lse : p.stats;  // delta: plane 0
        cp_async4(rows + r, ok ? src + st + row : src, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  const int rr[2] = {warp * 16 + g, warp * 16 + g + 8};
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();  // K/V and tile i's lse, delta have landed
    fence_async_smem();
    __syncthreads();              // ... for every thread; slot i - 1 is free
    issue(i + STAGES - 1);
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);  // tile i's Q and dO
    const int slot = i % STAGES, q0 = (first + i) * NT;
    const unsigned char* qs = ring + slot * 2 * TILE;
    const unsigned char* dos = qs + TILE;
    const float* lse_s = rows_ring + slot * 2 * NT;
    const float* delta_s = lse_s + NT;

    float s[NT / 2], dp[NT / 2];  // s^T = K Q^T, dp^T = V dO^T
    two_products<T, D, NT>(s, dp, ks, qs, vs, dos);

#pragma unroll
    for (int n = 0; n < NT / 8; ++n) {
      const int qi = n * 8 + 2 * t;  // this thread's two query columns
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + qi);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + qi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * n + e;
        const int key = k0 + rr[e >> 1];
        const int q = q0 + qi + (e & 1);
        const float lse2 = ((e & 1) ? l2.y : l2.x) * kLog2e;
        const float del = (e & 1) ? dl.y : dl.x;
        const bool valid = key < kv && q < p.sq && (!Causal || key <= q);
        const float pr =
            valid ? bwd_weight<Bounded>(s[idx], p.scale_log2, lse2) : 0.f;
        s[idx] = pr;                     // p^T
        dp[idx] = Rowsum ? pr * (dp[idx] - del) * p.scale  // ds^T
                         : pr * (dp[idx] - del);
      }
    }
    uint32_t pa[NT / 16][4], da[NT / 16][4];
#pragma unroll
    for (int kc = 0; kc < NT / 16; ++kc) {
      pack_a<T>(pa[kc], s, kc);
      pack_a<T>(da[kc], dp, kc);
    }
    pin(pa);
    pin(da);
    pin(dk);
    pin(dv);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < NT / 16; ++kc)
      wgmma_rs(dv, pa[kc], desc_mnmajor<NT>(dos, kc), 1, (T*)nullptr);
#pragma unroll
    for (int kc = 0; kc < NT / 16; ++kc)
      wgmma_rs(dk, da[kc], desc_mnmajor<NT>(qs, kc), 1, (T*)nullptr);
    wgmma_commit();
    wgmma_wait<0>();
    pin(dk);
    pin(dv);
  }
  cp_async_wait<0>();

  const float out_scale = Rowsum ? 1.f : p.scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + rr[r];
    if (row >= p.sk) continue;
    T* dko = dkg + row * p.dk_ss + 2 * t;
    T* dvo = dvg + row * p.dv_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dko + n * 8) =
          pack2<T>(dk[4 * n + 2 * r] * out_scale,
                   dk[4 * n + 2 * r + 1] * out_scale);
      *reinterpret_cast<uint32_t*>(dvo + n * 8) =
          pack2<T>(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
    }
  }
}

// the dq kernel, then the dk/dv kernel, on one stream; inner tiles of 64
// rows at D 64, 32 at D 128 (the dk/dv kernel then holds 2 x 64 fp32
// accumulators a thread)
template <typename T, int D, bool Rowsum, bool Bounded, bool Causal>
int launch_bwd_wgmma(const BwdParams& params, int batch, cudaStream_t stream) {
  constexpr int NT = D == 64 ? 64 : 32;
  BwdParams p = params;
  if (const cudaError_t err = bind_current_device()) return (int)err;
  const struct {
    CUtensorMap* map;
    const void* base;
    int rows;
    long long sb, ss, sh;
  } maps[4] = {{&p.k_map, p.k, p.sk, p.k_sb, p.k_ss, p.k_sh},
               {&p.v_map, p.v, p.sk, p.v_sb, p.v_ss, p.v_sh},
               {&p.q_map, p.q, p.sq, p.q_sb, p.q_ss, p.q_sh},
               {&p.do_map, p.dout, p.sq, p.do_sb, p.do_ss, p.do_sh}};
  for (const auto& m : maps)
    if (int rc = head_tensor_map<T>(m.map, m.base, D, m.rows, p.heads, batch,
                                    m.sb, m.ss, m.sh, NT))
      return rc;
  const dim3 dq_grid((p.sq + kBwdRows - 1) / kBwdRows, p.heads, batch);
  int rc = launch(attn_bwd_dq_wgmma<T, D, NT, Rowsum, Bounded, Causal>, p,
                  dq_grid, kBwdThreads, bwd_dq_smem<T, D, NT>(), stream);
  if (rc != 0) return rc;
  const dim3 dkdv_grid((p.sk + kBwdRows - 1) / kBwdRows, p.heads, batch);
  return launch(attn_bwd_dkdv_wgmma<T, D, NT, Rowsum, Bounded, Causal>, p,
                dkdv_grid, kBwdThreads, bwd_dkdv_smem<T, D, NT>(), stream);
}

}  // namespace vpt
