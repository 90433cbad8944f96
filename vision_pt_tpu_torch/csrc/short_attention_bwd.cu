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
//   x      = q k^T * scale * log2e           (fp32 accumulate)
//            clipped to +-60 * log2e when bounded
//   p      = exp2(x - lse * log2e)           0 at key columns >= kv_len,
//            with lse the forward's row log-sum-exp (short_attention.cu),
//            so p = e / max(sum_j e, 2^-100), the forward's weights
//   dv     = T(p)^T do
//   dp     = do v^T                          (fp32)
//   delta  = sum_j p * dp                    (fp32, the TPU kernel's)
//   ds     = p * (dp - delta)
//   dq     = T(ds) k * scale,  dk = T(ds)^T q * scale
//
// with T the inputs' type (bf16 or fp16); outputs in T. fp32 inputs keep
// fp32 throughout and recompute the row max and sum themselves (scalar
// kernels, a statistics sweep in the dq kernel): p from an fp32 lse carries
// the lse's rounding (half an ulp of |lse|, about 5e-7 at S 298), 2-3 times
// the TPU kernel's own error, which the fp32 tolerance (1e-5) of the tests
// does not leave room for.
//
// Bound at the JiT-B/16 256^2 train-step shape (B=64, S=298, H=12, D=64,
// bf16, bounded), on an H100 SXM:
//   bytes  q, k, v, do read and dq, dk, dv written: 7 * 64*298*768*2 B
//          = 205 MB -> 205 MB / 3.35 TB/s = 61 us
//   FLOPs  5 products of 2*B*H*S^2*D = 4.37e10 -> / 989 TFLOP/s = 44 us
// so the backward is bound by memory, at about 0.061 ms per call. Kernels
// #4 and #6 at the same shape move the same bytes: the same bound.
//
// Design. Dk/dv contract over QUERY rows and dq over KEY rows;
// blocks run in no order and may not add into one sum (no fp32 atomics:
// repeated calls give the same bits), so two launches, one warpgroup (128
// threads) a block:
//   1. dq kernel, one block per (64 query rows, head, batch): Q and dO
//      tiles stay in shared memory while K/V tiles of NT keys, up to kv_len,
//      stream twice through a double-buffered cp.async ring (49 KB, four
//      blocks an SM: more blocks beat keeping every K/V tile for both
//      sweeps, which fits two an SM). The first sweep takes
//      s = Q K^T and dp = dO V^T (wgmma from shared
//      memory) and sums delta = sum p * dp in registers, with p from the
//      lse (no running max, no rescaling); delta goes to an fp32 (B, H, Sq)
//      scratch for launch 2; the second sweep takes s and dp again, forms
//      ds in the accumulator registers and runs dq += T(ds) K as wgmma with
//      ds in registers.
//   2. dk/dv kernel, one block per (64 key rows, head, batch): K and V
//      stay, Q/dO tiles with their lse and delta stream through the ring;
//      s^T = K Q^T and dp^T = V dO^T (the key rows are the wgmma rows), then
//      dv += T(p^T) dO and dk += T(ds^T) Q with p^T and ds^T in registers.
// 9 (S, S, D) products in all, where the function needs 5: delta needs every
// key of a row before the first ds of that row exists. Taking delta as the
// row sum of do * o instead (o rounded to T) would save the first sweep (7
// products) but moves dq and dk by up to 4 times the bf16 tolerance the
// tests hold the plain version to against the TPU kernel; a single launch
// per (batch, head), 5 products, would hold dk and dv of every key (S 298:
// 5 warpgroups x 64 fp32 accumulators a thread, plus s and dp) and does not
// fit the register file of one SM.
// All tiles use the 128-byte swizzle, so one copy of a tile is read K-major
// by one product and MN-major by another (hopper.cuh).
// Rows past S are loaded as zeros; key rows >= kv_len get exactly zero dk,
// dv; a kv_len == 0 batch row gets zero grads (the TPU kernels of #4 and #6
// differentiate their uniform weights over the padded block there,
// unbounded; a kept divergence). The TPU kernel's head pairing is not
// ported: it only fills the TPU's 128-deep matrix unit.

#include "hopper.cuh"

using namespace vpt;

namespace {

constexpr int kRows = 64;     // query rows (dq kernel) / key rows (dk/dv) per block
constexpr int kThreads = 128; // one warpgroup
constexpr int kStages = 3;    // depth of the Q/dO ring of the dk/dv kernel
constexpr int kDqStages = 2;  // K/V ring of the dq kernel: 49 KB a block at
                              // D 64, four blocks an SM
constexpr int kTileF32 = 16;  // inner-loop rows per shared-memory tile, fp32
constexpr int kColsF32 = 32;  // columns of a row each thread holds, fp32

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Sq), natural log, from the forward (16-bit)
  void* dq;
  void* dk;
  void* dv;
  // (3, B, H, Sq) fp32 scratch: 16-bit, delta in plane 0; fp32, the row max
  // (log2 domain), denominator and delta
  float* stats;
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

__device__ __forceinline__ long long stat_offset(const BwdParams& p, int b,
                                                 int h) {
  return ((long long)b * p.heads + h) * p.sq;
}

__device__ __forceinline__ float clipped_exp2(float x) {
  const float lim = kClip * kLog2e;
  return exp2f(fminf(fmaxf(x, -lim), lim));
}

// the logit in the exp2 domain, clipped when bounded
__device__ __forceinline__ float logit2(float s, const BwdParams& p) {
  const float x = s * p.scale_log2;
  const float lim = kClip * kLog2e;
  return p.bounded ? fminf(fmaxf(x, -lim), lim) : x;
}

// ------------------------------------------------------ bf16, fp16 / wgmma

template <typename T, int D, int NT>
constexpr size_t dq_smem() {
  // Q, dO; the ring of K, V tiles; slack to align the tiles to 1024 bytes
  return 1024 + 2 * kRows * D * sizeof(T) + kDqStages * 2 * NT * D * sizeof(T);
}

template <typename T, int D, int NT>
constexpr size_t dkdv_smem() {
  // K, V; the ring of Q, dO tiles and of their lse and delta; slack
  return 1024 + 2 * kRows * D * sizeof(T) + kStages * 2 * NT * D * sizeof(T) +
         kStages * 2 * NT * sizeof(float);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(raw);
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  return reinterpret_cast<unsigned char*>(base + ((1024 - (s & 1023)) & 1023));
}

// s (+)= A B^T and dp (+)= C D^T over the D / 16 k16 steps of four swizzled
// tiles (A, C: 64 rows; B, D: NT rows), then wait for both
template <typename T, int D, int NT>
__device__ __forceinline__ void two_products(float (&s)[NT / 2], float (&dp)[NT / 2],
                                             const unsigned char* a,
                                             const unsigned char* b,
                                             const unsigned char* c,
                                             const unsigned char* d) {
  pin(s);
  pin(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, desc_kmajor<kRows>(a, kk), desc_kmajor<NT>(b, kk), kk,
             (T*)nullptr);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(dp, desc_kmajor<kRows>(c, kk), desc_kmajor<NT>(d, kk), kk,
             (T*)nullptr);
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
  pin(dp);
}

template <typename T, int D, int NT>
__global__ void __launch_bounds__(kThreads) packed_bwd_dq_wgmma(BwdParams p) {
  constexpr int TILE = NT * D * sizeof(T), QT = kRows * D * sizeof(T);
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* qs = aligned_smem(smem_wg);
  unsigned char* dos = qs + QT;
  unsigned char* ring = dos + QT;  // [kDqStages][K, V]

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv = clamped_len(p.kv_lens, b, p.sk);
  const int ntiles = (kv + NT - 1) / NT;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long st = stat_offset(p, b, h);

  cp_async_tile<kRows, D>(qs, qg, p.q_ss, q0, p.sq, kThreads);
  cp_async_tile<kRows, D>(dos, dog, p.do_ss, q0, p.sq, kThreads);
  cp_async_commit();
  // step j < ntiles: the first sweep over key tile j; then the second over
  // tile j - ntiles; each step's K/V tile into slot j % kDqStages, or an
  // empty group past the last step
  auto issue = [&](int j) {
    if (j < 2 * ntiles) {
      const int k0 = (j < ntiles ? j : j - ntiles) * NT;
      unsigned char* slot = ring + (j % kDqStages) * 2 * TILE;
      cp_async_tile<NT, D>(slot, kg, p.k_ss, k0, kv, kThreads);
      cp_async_tile<NT, D>(slot + TILE, vg, p.v_ss, k0, kv, kThreads);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kDqStages - 1; ++j) issue(j);

  const int rr[2] = {warp * 16 + g, warp * 16 + g + 8};
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse2[r] = q0 + rr[r] < p.sq ? p.lse[st + q0 + rr[r]] * kLog2e : 0.f;

  float delta[2] = {0.f, 0.f};  // this thread's partial sums, then the rows'
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  for (int j = 0; j < 2 * ntiles; ++j) {
    cp_async_wait<kDqStages - 2>();  // Q/dO and step j's tile have landed
    fence_async_smem();
    __syncthreads();                 // ... for every thread; slot j - 1 is free
    issue(j + kDqStages - 1);
    const bool second = j >= ntiles;
    const int k0 = (second ? j - ntiles : j) * NT;
    const unsigned char* ks = ring + (j % kDqStages) * 2 * TILE;
    const unsigned char* vs = ks + TILE;

    float s[NT / 2], dp[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) s[i] = dp[i] = 0.f;
    two_products<T, D, NT>(s, dp, qs, ks, dos, vs);

    if (j == ntiles) {  // the first sweep is done: whole-row delta
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
      const float pr = col < kv ? exp2f(logit2(s[i], p) - lse2[r]) : 0.f;
      if (second)
        s[i] = pr * (dp[i] - delta[r]);  // ds
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
  cp_async_wait<0>();

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rr[r];
    if (row >= p.sq) continue;
    T* out = dqg + row * p.dq_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          pack2<T>(dq[4 * n + 2 * r] * p.scale, dq[4 * n + 2 * r + 1] * p.scale);
  }
}

template <typename T, int D, int NT>
__global__ void __launch_bounds__(kThreads) packed_bwd_dkdv_wgmma(BwdParams p) {
  constexpr int TILE = NT * D * sizeof(T), KT = kRows * D * sizeof(T);
  constexpr int CH = D / 8;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* ks = aligned_smem(smem_wg);
  unsigned char* vs = ks + KT;
  unsigned char* ring = vs + KT;  // [kStages][Q, dO]
  float* rows_ring = reinterpret_cast<float*>(ring + kStages * 2 * TILE);  // [kStages][lse, delta][NT]

  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv = clamped_len(p.kv_lens, b, p.sk);

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  if (k0 >= kv) {  // every key of the tile is masked: zero grads
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
      const int row = k0 + i / CH, c = i % CH;
      if (row >= p.sk) continue;
      *reinterpret_cast<uint4*>(dkg + row * p.dk_ss + c * 8) = zero;
      *reinterpret_cast<uint4*>(dvg + row * p.dv_ss + c * 8) = zero;
    }
    return;
  }

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long st = stat_offset(p, b, h);
  const int ntiles = (p.sq + NT - 1) / NT;

  cp_async_tile<kRows, D>(ks, kg, p.k_ss, k0, kv, kThreads);
  cp_async_tile<kRows, D>(vs, vg, p.v_ss, k0, kv, kThreads);
  cp_async_commit();
  auto issue = [&](int i) {  // query tile i into its slot, or an empty group
    if (i < ntiles) {
      const int slot = i % kStages, q0 = i * NT;
      unsigned char* tiles = ring + slot * 2 * TILE;
      cp_async_tile<NT, D>(tiles, qg, p.q_ss, q0, p.sq, kThreads);
      cp_async_tile<NT, D>(tiles + TILE, dog, p.do_ss, q0, p.sq, kThreads);
      float* rows = rows_ring + slot * 2 * NT;
      for (int r = threadIdx.x; r < 2 * NT; r += kThreads) {
        const int row = q0 + (r % NT);
        const bool ok = row < p.sq;
        const float* src = r < NT ? p.lse : p.stats;  // delta: plane 0
        cp_async4(rows + r, ok ? src + st + row : src, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  const int rr[2] = {warp * 16 + g, warp * 16 + g + 8};
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();  // K/V and query tile i have landed
    fence_async_smem();
    __syncthreads();               // ... for every thread; slot i - 1 is free
    issue(i + kStages - 1);
    const int slot = i % kStages, q0 = i * NT;
    const unsigned char* qs = ring + slot * 2 * TILE;
    const unsigned char* dos = qs + TILE;
    const float* lse_s = rows_ring + slot * 2 * NT;
    const float* delta_s = lse_s + NT;

    float s[NT / 2], dp[NT / 2];  // s^T = K Q^T, dp^T = V dO^T
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) s[n] = dp[n] = 0.f;
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
        const float pr = (key < kv && q < p.sq) ? exp2f(logit2(s[idx], p) - lse2)
                                                : 0.f;
        s[idx] = pr;                       // p^T
        dp[idx] = pr * (dp[idx] - del);    // ds^T
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + rr[r];
    if (row >= p.sk) continue;
    T* dko = dkg + row * p.dk_ss + 2 * t;
    T* dvo = dvg + row * p.dv_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dko + n * 8) =
          pack2<T>(dk[4 * n + 2 * r] * p.scale, dk[4 * n + 2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvo + n * 8) =
          pack2<T>(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
    }
  }
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

// the wgmma pair for T and D: inner tiles of 64 rows at D 64, 32 at D 128
// (the dk/dv kernel then holds 2 x 64 fp32 accumulators a thread)
template <typename T, int D>
int launch_wgmma(const BwdParams& p, int batch, cudaStream_t s) {
  constexpr int NT = D == 64 ? 64 : 32;
  return launch_pair(packed_bwd_dq_wgmma<T, D, NT>,
                     packed_bwd_dkdv_wgmma<T, D, NT>, p, batch, kThreads,
                     dq_smem<T, D, NT>(), dkdv_smem<T, D, NT>(), s);
}

// Launches the dq kernel, then the dk/dv kernel, for dtype (0 = bf16,
// 1 = fp32, 2 = fp16) and head_dim. Returns 0, a cudaError_t code, or -1 for
// a head_dim/dtype pair this file has no kernel for.
int run_bwd(const BwdParams& p, int batch, int head_dim, int dtype,
            cudaStream_t s) {
  if (dtype == 0) {
    if (head_dim == 64) return launch_wgmma<__nv_bfloat16, 64>(p, batch, s);
    if (head_dim == 128) return launch_wgmma<__nv_bfloat16, 128>(p, batch, s);
  } else if (dtype == 2) {
    if (head_dim == 64) return launch_wgmma<__half, 64>(p, batch, s);
    if (head_dim == 128) return launch_wgmma<__half, 128>(p, batch, s);
  } else if (dtype == 1) {
    constexpr size_t stats_smem = 3 * kTileF32 * sizeof(float);
    const size_t rows = 2 * kRows, tile = 2 * kTileF32;
    if (head_dim == 64)
      return launch_pair(packed_bwd_dq_f32<64>, packed_bwd_dkdv_f32<64>, p,
                         batch, kRows * 64 / kColsF32,
                         (rows * 65 + tile * 64) * sizeof(float),
                         (rows * 65 + tile * 64) * sizeof(float) + stats_smem, s);
    if (head_dim == 128)
      return launch_pair(packed_bwd_dq_f32<128>, packed_bwd_dkdv_f32<128>, p,
                         batch, kRows * 128 / kColsF32,
                         (rows * 129 + tile * 128) * sizeof(float),
                         (rows * 129 + tile * 128) * sizeof(float) + stats_smem,
                         s);
  }
  return -1;
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32, 2 = fp16. `strides` holds (batch, row, head)
// strides in elements for q, k, v, dout, dq, dk, dv in that order (21
// values); the last dimension of every tensor is contiguous. `lse` is the
// forward's fp32 (B, H, Sq) log-sum-exp (read for bf16 and fp16), `stats`
// fp32 scratch of 3 * B * H * Sq. Launches the dq kernel, then the dk/dv
// kernel, on `stream`. Returns 0, a cudaError_t code, or -1 for a
// head_dim/dtype pair this file has no kernel for.
extern "C" int vpt_short_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, void* dq, void* dk, void* dv, float* stats,
    const int* kv_lens, int batch, int sq, int sk, int heads, int head_dim,
    const long long* strides, float scale, int bounded, int dtype,
    void* stream) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.stats = stats;
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
  p.plane = (long long)batch * heads * sq;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.bounded = bounded;
  return run_bwd(p, batch, head_dim, dtype, static_cast<cudaStream_t>(stream));
}
