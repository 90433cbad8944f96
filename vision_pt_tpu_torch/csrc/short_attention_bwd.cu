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
// Design. The 16-bit kernels are the pair of attention_bwd.cuh (a dq
// launch, then a dk/dv launch; wgmma over TMA rings; no atomics), with
// delta from the dq kernel's first sweep over the key tiles: its K/V ring is
// double-buffered (49 KB at D 64, four blocks an SM: more blocks beat
// keeping every K/V tile for both sweeps, which fits two an SM), the dk/dv
// kernel's Q/dO ring three deep. 9 (S, S, D) products in all, where the
// function needs 5: delta needs every key of a row before the first ds of
// that row exists. Taking delta as the row sum of do * o instead (o rounded
// to T), as #8 does, would save the first sweep (7 products) but moves dq
// and dk by up to 4 times the bf16 tolerance the tests hold the plain
// version to against the TPU kernel; a single launch per (batch, head), 5
// products, would hold dk and dv of every key (S 298: 5 warpgroups x 64
// fp32 accumulators a thread, plus s and dp) and does not fit the register
// file of one SM.
// Rows past S are loaded as zeros; key rows >= kv_len get exactly zero dk,
// dv; a kv_len == 0 batch row gets zero grads (the TPU kernels of #4 and #6
// differentiate their uniform weights over the padded block there,
// unbounded; a kept divergence). The TPU kernel's head pairing is not
// ported: it only fills the TPU's 128-deep matrix unit.

#include "attention_bwd.cuh"

using namespace vpt;

namespace {

constexpr int kRows = 64;     // query / key rows of an fp32 block
constexpr int kTileF32 = 16;  // inner-loop rows per shared-memory tile, fp32
constexpr int kColsF32 = 32;  // columns of a row each thread holds, fp32

__device__ __forceinline__ float clipped_exp2(float x) {
  const float lim = kClip * kLog2e;
  return exp2f(fminf(fmaxf(x, -lim), lim));
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

// the wgmma pair of attention_bwd.cuh for T and D, delta from the first
// sweep, bounded or not
template <typename T, int D>
int launch_wgmma(const BwdParams& p, int batch, cudaStream_t s) {
  if (p.bounded) return launch_bwd_wgmma<T, D, false, true, false>(p, batch, s);
  return launch_bwd_wgmma<T, D, false, false, false>(p, batch, s);
}

// Launches the dq kernel, then the dk/dv kernel, for dtype (0 = bf16, 1 =
// fp32, 2 = fp16) and head_dim. Returns 0, a cudaError_t (or, for a refused
// tensor map, CUresult) code, or -1 for a head_dim/dtype pair this file has
// no kernel for.
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
// kernel, on `stream`. Returns 0, a cudaError_t (or, for a refused tensor
// map, CUresult) code, or -1 for a head_dim/dtype pair this file has no
// kernel for.
extern "C" int vpt_short_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, void* dq, void* dk, void* dv, float* stats,
    const int* kv_lens, int batch, int sq, int sk, int heads, int head_dim,
    const long long* strides, float scale, int bounded, int dtype,
    void* stream) {
  BwdParams p{};  // no o: delta from the sweep
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
