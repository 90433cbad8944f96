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
// with T the inputs' type, bf16 or fp16 (one template, fp32 accumulation);
// outputs in T. fp32 inputs keep fp32 throughout. Key rows at or past kv_len
// get exactly zero dk, dv; a kv_len 0 batch row gets zero gradients
// everywhere.
//
// Bound at the latent JiT 1024^2 training shape (B = 16, S = 4170, H = 12,
// D = 64, bf16, kv_lens near S), on an H100 SXM:
//   FLOPs  5 products of 2*B*H*S^2*D (q k^T, do v^T, p^T do, ds k, ds^T q)
//          = 2.1e12 -> / 989 TFLOP/s = 2.2 ms
//   bytes  q, k, v, o, do read and dq, dk, dv written: 8 * 0.103 GB
//          = 0.82 GB -> / 3.35 TB/s = 0.25 ms
// so the backward is bound by the tensor cores, at about 2.2 ms per call.
//
// Design. The 16-bit kernels are the pair of attention_bwd.cuh, which #2
// shares (two launches, deterministic, no atomics; wgmma over TMA rings,
// the next tile's copy in flight during this tile's products), with
// delta = rowsum(do * o) taken by the dq kernel from the stored o before its
// one sweep over the key tiles, and causal as a template parameter: the dq
// kernel stops its key loop at the diagonal, the dk/dv kernel starts its
// query loop there. The TPU kernels carry dq (and dk/dv) across a sequential
// grid axis in VMEM; blocks on Hopper run in no order, and dk/dv contract
// over query rows, hence the two launches and 7 executed (S, S, D) products
// (s and dp in both kernels) where the function needs 5. fp32 inputs take
// scalar FMA kernels.

#include "attention_bwd.cuh"

using namespace vpt;

namespace {

constexpr int kRows = 64;     // query / key rows of an fp32 block
constexpr int kTileF32 = 16;  // inner-loop rows per shared-memory tile, fp32
constexpr int kColsF32 = 32;  // columns of a row each thread holds, fp32

__device__ __forceinline__ bool valid_pair(const BwdParams& p, int kv, int key,
                                           int row) {
  return key < kv && row < p.sq && (!p.causal || key <= row);
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
  if (c0 == 0 && row < p.sq) p.stats[st + row] = delta;

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
      st_delta[i] = in ? p.stats[st + q0 + i] : 0.f;
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

// the wgmma pair of attention_bwd.cuh for T and D, delta from rowsum(do * o),
// causal or not
template <typename T, int D>
int launch_wgmma(const BwdParams& p, int batch, cudaStream_t s) {
  if (p.causal) return launch_bwd_wgmma<T, D, true, false, true>(p, batch, s);
  return launch_bwd_wgmma<T, D, true, false, false>(p, batch, s);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32, 2 = fp16. Strides are in elements, (batch, row,
// head) for each of q, k, v, o, do, dq, dk, dv; the last dimension of every
// tensor is contiguous. `lse` is the forward's fp32 (B, H, Sq); `delta` fp32
// scratch of B * H * Sq. Launches the dq kernel, then the dk/dv kernel, on
// `stream`. Returns 0, a cudaError_t (or, for a refused tensor map, CUresult)
// code, or -1 for a head_dim/dtype pair this file has no kernel for.
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
  BwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.stats = delta;  // delta in plane 0
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
  if (dtype == 0) {
    if (head_dim == 64) return launch_wgmma<__nv_bfloat16, 64>(p, batch, s);
    if (head_dim == 128) return launch_wgmma<__nv_bfloat16, 128>(p, batch, s);
  } else if (dtype == 2) {
    if (head_dim == 64) return launch_wgmma<__half, 64>(p, batch, s);
    if (head_dim == 128) return launch_wgmma<__half, 128>(p, batch, s);
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
