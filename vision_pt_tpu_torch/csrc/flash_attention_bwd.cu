// Flash attention, backward, for Hopper (sm_90a).
//
// Replaces vision_pt_tpu/ops/flash_attention.py::_flash_backward (its Pallas
// TPU kernels _dq_kernel and _dkv_kernel, and the delta it takes in XLA), the
// backward of flash_attention. Per (batch, head), over (B, S, H, D) tensors
// read in place through (batch, row, head) strides:
//
//   delta = sum_d do * o                       (fp32, from the stored o)
//   p     = exp(q k^T * scale - lse)           on the valid set, else 0
//           (valid: key < kv_len, and key <= row when causal)
//   dv    = T(p)^T do
//   dp    = do v^T                             (fp32)
//   ds    = T(p * (dp - delta) * scale)
//   dq    = ds k,   dk = ds^T q
//
// with T the inputs' type, bf16 or fp16 (one template, mma.sync fragments of
// T with fp32 accumulation); outputs in T. fp32 inputs keep fp32 throughout. Key rows at
// or past kv_len get exactly zero dk, dv; a kv_len 0 batch row gets zero
// gradients everywhere.
//
// Bound at the latent JiT 1024^2 training shape (B = 16, S = 4170, H = 12,
// D = 64, bf16, kv_lens near S), on an H100 SXM:
//   FLOPs  5 products of 2*B*H*S^2*D (q k^T, do v^T, p^T do, ds k, ds^T q)
//          = 2.1e12 -> / 989 TFLOP/s = 2.2 ms
//   bytes  q, k, v, o, do read and dq, dk, dv written: 8 * 0.103 GB
//          = 0.82 GB -> / 3.35 TB/s = 0.25 ms
// so the backward is bound by the tensor cores, at about 2.2 ms per call.
//
// Design (simple first): the two launches that kernel #2
// (short_attention_bwd.cu) proved, deterministic, no atomics. The TPU
// kernels carry dq (and dk/dv) across a sequential grid axis in VMEM; blocks
// on Hopper run in no order, and dk/dv contract over query rows, so:
//   1. dq kernel, one block per (64 query rows, head, batch): its prologue
//      takes delta from do and o and writes it to an fp32 (B, H, Sq) scratch;
//      then it streams K/V tiles up to kv_len (the diagonal when causal),
//      recomputes p from the forward's LSE and accumulates dq = ds k in
//      mma.sync fragments.
//   2. dk/dv kernel, one block per (64 key rows, head, batch), after it on the
//      same stream: K/V rows stay in shared memory, it loops over query tiles
//      (from the diagonal when causal) and computes the scores transposed
//      (s^T = k q^T), so key rows are the fragment rows and p^T, ds^T feed the
//      dv and dk products straight from registers. A key tile wholly past
//      kv_len writes zeros and stops.
// B operands stored (k, n) row major come in through ldmatrix.trans. fp32
// inputs take scalar FMA kernels. wgmma, TMA and pipelining are left for
// later work.

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
  const void* o;
  const void* dout;
  const float* lse;    // (B, H, Sq), natural log
  void* dq;
  void* dk;
  void* dv;
  float* delta;        // (B, H, Sq) scratch, written by the dq kernel
  const int* kv_lens;  // (B,) or null for "all Sk keys"
  int heads, sq, sk;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // elements
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  float scale;       // softmax scale
  float scale_log2;  // scale * log2(e)
  int causal;
};

__device__ __forceinline__ bool valid_pair(const BwdParams& p, int kv, int key,
                                           int row) {
  return key < kv && row < p.sq && (!p.causal || key <= row);
}

__device__ __forceinline__ long long stat_offset(const BwdParams& p, int b,
                                                 int h) {
  return ((long long)b * p.heads + h) * p.sq;
}

// ------------------------------------------------------- bf16, fp16 / mma

template <typename T, int D, int KT>
__global__ void __launch_bounds__(128) flash_bwd_dq_mma(BwdParams p) {
  constexpr int LD = D + 8, NT = KT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kRows * LD;
  T* ks = dos + kRows * LD;
  T* vs = ks + KT * LD;
  float* st_lse2 = reinterpret_cast<float*>(vs + KT * LD);
  float* st_delta = st_lse2 + kRows;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
  const int kv = clamped_len(p.kv_lens, b, p.sk);
  const int kend = p.causal ? min(kv, q0 + kRows) : kv;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* og = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long st = stat_offset(p, b, h);

  load_rows2_16<D>(qs, dos, qg, dog, p.q_ss, p.do_ss, q0, kRows, p.sq);
  __syncthreads();

  // prologue: delta = sum_d do * o, two threads per row
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = q0 + r;
    float d = 0.f;
    if (row < p.sq) {
      const T* orow = og + row * p.o_ss + half * (D / 2);
      const T* drow = dos + r * LD + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; ++c)
        d = fmaf(to_float(drow[c]), to_float(orow[c]), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      st_delta[r] = d;
      st_lse2[r] = row < p.sq ? p.lse[st + row] * kLog2e : 0.f;
      if (row < p.sq) p.delta[st + row] = d;
    }
  }
  __syncthreads();
  const float lse2[2] = {st_lse2[r0], st_lse2[r0 + 8]};
  const float delta[2] = {st_delta[r0], st_delta[r0 + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += KT) {
    __syncthreads();
    load_rows2_16<D>(ks, vs, kg, vg, p.k_ss, p.v_ss, k0, KT, kv);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    warp_abt<D, NT>(s, qs, ks, r0, g, t);
    warp_abt<D, NT>(dp, dos, vs, r0, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const float pr = valid_pair(p, kv, col, q0 + r0 + 8 * r)
                             ? exp2f(s[j][e] * p.scale_log2 - lse2[r])
                             : 0.f;
        s[j][e] = pr * (dp[j][e] - delta[r]) * p.scale;  // ds
      }
    warp_fx<D, NT>(acc, s, ks, lane);
  }
  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows16<D>(dqg, p.dq_ss, acc, q0 + r0, p.sq, 1.f, t);
}

template <typename T, int D, int QT>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_mma(BwdParams p) {
  constexpr int LD = D + 8, NQ = QT / 8, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kRows * LD;
  T* qs = vs + kRows * LD;
  T* dos = qs + QT * LD;
  float* st_lse2 = reinterpret_cast<float*>(dos + QT * LD);
  float* st_delta = st_lse2 + QT;

  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
  const int kv = clamped_len(p.kv_lens, b, p.sk);

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
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

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long st = stat_offset(p, b, h);

  load_rows2_16<D>(ks, vs, kg, vg, p.k_ss, p.v_ss, k0, kRows, kv);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  // causal: rows below k0 attend no key of this tile (k0 is a multiple of QT)
  for (int q0 = p.causal ? k0 : 0; q0 < p.sq; q0 += QT) {
    __syncthreads();
    load_rows2_16<D>(qs, dos, qg, dog, p.q_ss, p.do_ss, q0, QT, p.sq);
    for (int i = threadIdx.x; i < QT; i += blockDim.x) {
      const bool in = q0 + i < p.sq;
      st_lse2[i] = in ? p.lse[st + q0 + i] * kLog2e : 0.f;
      st_delta[i] = in ? p.delta[st + q0 + i] : 0.f;
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
        const float pr = valid_pair(p, kv, key, q0 + qi)
                             ? exp2f(s[j][e] * p.scale_log2 - st_lse2[qi])
                             : 0.f;
        s[j][e] = pr;                                          // p^T
        dp[j][e] = pr * (dp[j][e] - st_delta[qi]) * p.scale;  // ds^T
      }
    warp_fx<D, NQ>(dv, s, dos, lane);
    warp_fx<D, NQ>(dk, dp, qs, lane);
  }
  store_rows16<D>(dkg, p.dk_ss, dk, k0 + r0, p.sk, 1.f, t);
  store_rows16<D>(dvg, p.dv_ss, dv, k0 + r0, p.sk, 1.f, t);
}

// ------------------------------------------------------------ fp32 / scalar
//
// D / 32 adjacent threads share a row: each holds 32 of its D columns and
// the partial dot products are summed with shuffles.

template <int D>
__global__ void __launch_bounds__(kRows * (D / kColsF32)) flash_bwd_dq_f32(BwdParams p) {
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
  const int row = q0 + rl;
  const int kv = clamped_len(p.kv_lens, b, p.sk);
  const int kend = p.causal ? min(kv, q0 + kRows) : kv;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* og = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long st = stat_offset(p, b, h);

  load_rows_f32<D>(qs, qg, p.q_ss, q0, kRows, p.sq, QLD);
  load_rows_f32<D>(dos, dog, p.do_ss, q0, kRows, p.sq, QLD);
  __syncthreads();
  const float* qrow = qs + rl * QLD + c0;
  const float* dorow = dos + rl * QLD + c0;

  float delta = 0.f;
  if (row < p.sq) {
    const float* orow = og + row * p.o_ss + c0;
#pragma unroll
    for (int d = 0; d < kColsF32; ++d) delta = fmaf(dorow[d], orow[d], delta);
  }
  delta = row_sum<P>(delta);
  const float lse2 = row < p.sq ? p.lse[st + row] * kLog2e : 0.f;
  if (c0 == 0 && row < p.sq) p.delta[st + row] = delta;

  float acc[kColsF32];
#pragma unroll
  for (int d = 0; d < kColsF32; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += kTileF32) {
    __syncthreads();
    load_rows_f32<D>(ks, kg, p.k_ss, k0, kTileF32, kv, D);
    load_rows_f32<D>(vs, vg, p.v_ss, k0, kTileF32, kv, D);
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
      const float dp = row_sum<P>(pd);
      const float pr = valid_pair(p, kv, k0 + j, row) ? exp2f(x - lse2) : 0.f;
      const float ds = pr * (dp - delta) * p.scale;
#pragma unroll
      for (int d = 0; d < kColsF32; ++d) acc[d] = fmaf(ds, ks[j * D + c0 + d], acc[d]);
    }
  }
  if (row < p.sq) {
    float* out = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh + row * p.dq_ss + c0;
#pragma unroll
    for (int d = 0; d < kColsF32; ++d) out[d] = acc[d];
  }
}

template <int D>
__global__ void __launch_bounds__(kRows * (D / kColsF32)) flash_bwd_dkdv_f32(BwdParams p) {
  constexpr int P = D / kColsF32, QLD = D + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kRows * QLD;
  float* qs = vs + kRows * QLD;
  float* dos = qs + kTileF32 * D;
  float* st_lse2 = dos + kTileF32 * D;
  float* st_delta = st_lse2 + kTileF32;

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
  const long long st = stat_offset(p, b, h);

  load_rows_f32<D>(ks, kg, p.k_ss, k0, kRows, kv, QLD);
  load_rows_f32<D>(vs, vg, p.v_ss, k0, kRows, kv, QLD);
  const float* krow = ks + rl * QLD + c0;
  const float* vrow = vs + rl * QLD + c0;

  float dk[kColsF32], dv[kColsF32];
#pragma unroll
  for (int d = 0; d < kColsF32; ++d) dk[d] = dv[d] = 0.f;
  // causal: rows below k0 attend no key of this tile
  for (int q0 = p.causal ? k0 : 0; q0 < p.sq; q0 += kTileF32) {
    __syncthreads();
    load_rows_f32<D>(qs, qg, p.q_ss, q0, kTileF32, p.sq, D);
    load_rows_f32<D>(dos, dog, p.do_ss, q0, kTileF32, p.sq, D);
    for (int i = tid; i < kTileF32; i += blockDim.x) {
      const bool in = q0 + i < p.sq;
      st_lse2[i] = in ? p.lse[st + q0 + i] * kLog2e : 0.f;
      st_delta[i] = in ? p.delta[st + q0 + i] : 0.f;
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
      const float dp = row_sum<P>(pd);
      const float pr = valid_pair(p, kv, key, q0 + i) ? exp2f(x - st_lse2[i]) : 0.f;
      const float ds = pr * (dp - st_delta[i]) * p.scale;
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
      dkg[key * p.dk_ss + c0 + d] = dk[d];
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

}  // namespace

// dtype: 0 = bf16, 1 = fp32, 2 = fp16. Strides are in elements, (batch, row, head) for
// each of q, k, v, o, do, dq, dk, dv; the last dimension of every tensor is
// contiguous. `lse` is the forward's fp32 (B, H, Sq); `delta` fp32 scratch of
// B * H * Sq. Launches the dq kernel, then the dk/dv kernel, on `stream`.
// Returns 0, a cudaError_t code, or -1 for a head_dim/dtype pair this file has
// no kernel for.
extern "C" int vpt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* delta, const int* kv_lens, int batch, int sq, int sk, int heads,
    int head_dim, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh, long long dk_sb,
    long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,
    long long dv_sh, float scale, int causal, int dtype, void* stream) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.delta = delta;
  p.kv_lens = kv_lens;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.do_sb = do_sb;
  p.do_ss = do_ss;
  p.do_sh = do_sh;
  p.dq_sb = dq_sb;
  p.dq_ss = dq_ss;
  p.dq_sh = dq_sh;
  p.dk_sb = dk_sb;
  p.dk_ss = dk_ss;
  p.dk_sh = dk_sh;
  p.dv_sb = dv_sb;
  p.dv_ss = dv_ss;
  p.dv_sh = dv_sh;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr size_t rows_smem = 2 * kRows * sizeof(float);
  if (dtype == 0 || dtype == 2) {
    if (head_dim == 64)
      return dtype == 0
          ? launch_pair(flash_bwd_dq_mma<__nv_bfloat16, 64, 64>,
                        flash_bwd_dkdv_mma<__nv_bfloat16, 64, 64>, p, batch, 128,
                        bf16_smem(64, 64) + rows_smem,
                        bf16_smem(64, 64) + rows_smem, s)
          : launch_pair(flash_bwd_dq_mma<__half, 64, 64>,
                        flash_bwd_dkdv_mma<__half, 64, 64>, p, batch, 128,
                        bf16_smem(64, 64) + rows_smem,
                        bf16_smem(64, 64) + rows_smem, s);
    if (head_dim == 128)
      return dtype == 0
          ? launch_pair(flash_bwd_dq_mma<__nv_bfloat16, 128, 32>,
                        flash_bwd_dkdv_mma<__nv_bfloat16, 128, 32>, p, batch,
                        128, bf16_smem(128, 32) + rows_smem,
                        bf16_smem(128, 32) + rows_smem, s)
          : launch_pair(flash_bwd_dq_mma<__half, 128, 32>,
                        flash_bwd_dkdv_mma<__half, 128, 32>, p, batch, 128,
                        bf16_smem(128, 32) + rows_smem,
                        bf16_smem(128, 32) + rows_smem, s);
  } else if (dtype == 1) {
    const size_t rows = 2 * kRows, tile = 2 * kTileF32;
    if (head_dim == 64)
      return launch_pair(flash_bwd_dq_f32<64>, flash_bwd_dkdv_f32<64>, p,
                         batch, kRows * 64 / kColsF32,
                         (rows * 65 + tile * 64) * sizeof(float),
                         (rows * 65 + tile * 64 + 2 * kTileF32) * sizeof(float), s);
    if (head_dim == 128)
      return launch_pair(flash_bwd_dq_f32<128>, flash_bwd_dkdv_f32<128>, p,
                         batch, kRows * 128 / kColsF32,
                         (rows * 129 + tile * 128) * sizeof(float),
                         (rows * 129 + tile * 128 + 2 * kTileF32) * sizeof(float),
                         s);
  }
  return -1;
}
