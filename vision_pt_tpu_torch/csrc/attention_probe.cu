// The two attention probes' kernels, for Hopper (sm_90a): kernel #10 (the
// pairing probe's bounded attention forward and backward) and kernel #11 (the
// roofline probe's attention products with no softmax).
//
// Both work on (B, S, H*D) bf16 tensors, contiguous, with heads as D-wide
// column slices (D = 64), and take q, k, v and the output cotangent do as four
// pointers; the probes pass one tensor x for all four, as the TPU probes do.
// Both follow kernel #2's split (short_attention_bwd.cu): the products that
// contract over key rows (o, dq) run in a query-row launch, one block per (64
// query rows, head, batch), which writes them in fp32 to scratch; the
// products that contract over query rows (dv, dk) run in a key-row launch,
// one block per (64 key rows, head, batch), which adds the scratch of its own
// rows (the probes' q and k have the same rows) and rounds each output to
// bf16 once. 4 warps of 16 rows, mma.sync m16n8k16 bf16 with fp32 fragments,
// tiles of 64 rows in shared memory, rows past S loaded as zeros. Simple and
// right first: no pipelining, no wgmma.
//
// vpt_attention_pairing_probe (kernel #10) replaces
// tools/bench/attention_pairing_probe.py::run_variant (its pallas_call over
// _base_kernel; _paired_kernel computes the same function on the TPU's
// 128-deep matrix unit, which mma.sync has no half-idle depth pass to fill,
// so the paired schedule is not ported). Per (batch, head), no mask:
//
//   s     = q k^T (fp32);  e = exp2(clip(s * scale * log2e, +-60 * log2e))
//   denom = max(sum_j e, 2^-100);  p = e / denom
//   o     = bf16(e) v / denom;  dv = bf16(p)^T do
//   dp    = do v^T;  delta = sum_j p * dp;  ds = bf16(p * (dp - delta))
//   dq    = ds k * scale;  dk = ds^T q * scale
//   out1  = bf16(o + dv),  out2 = bf16(dq + dk)   (each sum in fp32)
//
// Bound at the probe's shape (B 64, S 304, H 12, D 64), on an H100 SXM: six
// products of 2*B*H*S^2*D = 9.08 GFLOP, 54.5 GFLOP -> 0.0551 ms at 989
// TFLOP/s; bytes x read once and two outputs written, 3 * 29.9 MB = 89.6 MB
// -> 0.0268 ms at 3.35 TB/s: bound by operations, 0.0551 ms.
//
// vpt_attention_dots_probe (kernel #11) replaces
// tools/bench/attention_roofline.py::dots_variant (its pallas_call over
// _dots_only_kernel; _dots_only_paired_kernel is the paired schedule of the
// same function, not ported for the reason above). Per (batch, head), the
// products of attention's forward and backward with no softmax, scale or
// mask:
//
//   s  = q k^T (fp32, twice on the TPU: forward and recompute)
//   o  = bf16(s) v;  dv = bf16(s)^T do
//   dp = do v^T;     dq = bf16(dp) k;  dk = bf16(dp)^T q
//   out = bf16((o + dq) + (dv + dk))   (each sum in fp32, accumulated in the
//                                       products' fragments)
//
// The function needs six products: s is one product, which the TPU probe
// computes twice (its seven dots) and this kernel computes twice as well (s in
// the query-row launch, s^T in the key-row launch, and likewise dp and dp^T:
// eight products). Bound at the probe's shape: the function's six products,
// 6 * 9.08 = 54.5 GFLOP -> 0.0551 ms; bytes x read once and one output
// written, 59.8 MB -> 0.0178 ms: bound by operations, 0.0551 ms. The bounds
// count the products as the probes define them over q, k, v and do; that the
// probes pass one tensor for all four is their input, not a property a kernel
// may use.

#include "attention_common.cuh"

using namespace vpt;

namespace {

constexpr int kD = 64;     // head dim
constexpr int kRows = 64;  // rows of a block, and of a streamed tile

struct ProbeParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  __nv_bfloat16* out1;  // #10: o + dv;  #11: o + dq + dv + dk
  __nv_bfloat16* out2;  // #10: dq + dk; #11: unused
  float* acc1;          // (B, S, H*D) fp32 scratch: #10 o; #11 o + dq
  float* acc2;          // #10 dq; #11 unused
  float* stats;         // #10: (2, B, H, S) denominator, delta
  int heads, seq;
  float scale, scale_log2;
};

__device__ __forceinline__ float clipped_exp2(float x) {
  const float lim = kClip * kLog2e;
  return exp2f(fminf(fmaxf(x, -lim), lim));
}

// rows row0 and row0 + 8 of a (16 x D) fragment accumulator -> fp32 (S, D)
// head slice with row stride `stride`, below `limit`
__device__ __forceinline__ void store_rows_f32(float* dst, long long stride,
                                               const float acc[kD / 8][4],
                                               int row0, int limit, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= limit) continue;
    float* out = dst + row * stride + 2 * t;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
      *reinterpret_cast<float2*>(out + dn * 8) =
          make_float2(acc[dn][2 * r], acc[dn][2 * r + 1]);
  }
}

// out[row] = bf16(a[row] + b * mul) for rows row0 and row0 + 8 of the
// fragment accumulator b, a read from fp32 scratch: the one rounding
__device__ __forceinline__ void store_sum_bf16(__nv_bfloat16* dst,
                                               const float* a, long long stride,
                                               const float b[kD / 8][4],
                                               float mul, int row0, int limit,
                                               int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= limit) continue;
    const float* in = a + row * stride + 2 * t;
    __nv_bfloat16* out = dst + row * stride + 2 * t;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      const float2 x = *reinterpret_cast<const float2*>(in + dn * 8);
      *reinterpret_cast<uint32_t*>(out + dn * 8) = pack_bf16(
          x.x + b[dn][2 * r] * mul, x.y + b[dn][2 * r + 1] * mul);
    }
  }
}

__device__ __forceinline__ void zero(float acc[kD / 8][4]) {
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
}

// -------------------------------------------------------------- kernel #10

__global__ void __launch_bounds__(128) pairing_probe_rows(ProbeParams p) {
  constexpr int LD = kD + 8, NT = kRows / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kRows * LD;
  __nv_bfloat16* ks = dos + kRows * LD;
  __nv_bfloat16* vs = ks + kRows * LD;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
  const long long ss = (long long)p.heads * kD;
  const long long off = b * p.seq * ss + h * kD;

  load_rows2_16<kD>(qs, dos, p.q + off, p.dout + off, ss, ss, q0, kRows, p.seq);

  // pass 1: the row sums of e and of e * dp (this thread's partial sums)
  float l_run[2] = {0.f, 0.f}, d_run[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < p.seq; k0 += kRows) {
    __syncthreads();
    load_rows2_16<kD>(ks, vs, p.k + off, p.v + off, ss, ss, k0, kRows, p.seq);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    warp_abt<kD, NT>(s, qs, ks, r0, g, t);
    warp_abt<kD, NT>(dp, dos, vs, r0, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const float x = col < p.seq ? clipped_exp2(s[j][e] * p.scale_log2) : 0.f;
        l_run[e >> 1] += x;
        d_run[e >> 1] += x * dp[j][e];
      }
  }
  float denom[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    denom[r] = fmaxf(row_sum<4>(l_run[r]), kDenomFloor);
    delta[r] = row_sum<4>(d_run[r]) / denom[r];
    const int row = q0 + r0 + 8 * r;
    if (t == 0 && row < p.seq) {
      float* st = p.stats + ((long long)b * p.heads + h) * p.seq + row;
      st[0] = denom[r];
      st[(long long)gridDim.z * p.heads * p.seq] = delta[r];
    }
  }

  // pass 2: o = bf16(e) v (unnormalised) and dq = ds k
  float o[kD / 8][4], dq[kD / 8][4];
  zero(o);
  zero(dq);
  for (int k0 = 0; k0 < p.seq; k0 += kRows) {
    __syncthreads();
    load_rows2_16<kD>(ks, vs, p.k + off, p.v + off, ss, ss, k0, kRows, p.seq);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    warp_abt<kD, NT>(s, qs, ks, r0, g, t);
    warp_abt<kD, NT>(dp, dos, vs, r0, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const float ex = col < p.seq ? clipped_exp2(s[j][e] * p.scale_log2) : 0.f;
        s[j][e] = ex;
        dp[j][e] = ex / denom[r] * (dp[j][e] - delta[r]);  // ds
      }
    warp_fx<kD, NT>(o, s, vs, lane);
    warp_fx<kD, NT>(dq, dp, ks, lane);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= p.seq) continue;
    float* o_out = p.acc1 + off + row * ss + 2 * t;
    float* dq_out = p.acc2 + off + row * ss + 2 * t;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      *reinterpret_cast<float2*>(o_out + dn * 8) =
          make_float2(o[dn][2 * r] / denom[r], o[dn][2 * r + 1] / denom[r]);
      *reinterpret_cast<float2*>(dq_out + dn * 8) =
          make_float2(dq[dn][2 * r] * p.scale, dq[dn][2 * r + 1] * p.scale);
    }
  }
}

__global__ void __launch_bounds__(128) pairing_probe_cols(ProbeParams p) {
  constexpr int LD = kD + 8, NQ = kRows / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kRows * LD;
  __nv_bfloat16* qs = vs + kRows * LD;
  __nv_bfloat16* dos = qs + kRows * LD;
  float* st_d = reinterpret_cast<float*>(dos + kRows * LD);
  float* st_delta = st_d + kRows;

  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
  const long long ss = (long long)p.heads * kD;
  const long long off = b * p.seq * ss + h * kD;
  const long long plane = (long long)gridDim.z * p.heads * p.seq;
  const float* st = p.stats + ((long long)b * p.heads + h) * p.seq;

  load_rows2_16<kD>(ks, vs, p.k + off, p.v + off, ss, ss, k0, kRows, p.seq);
  float dk[kD / 8][4], dv[kD / 8][4];
  zero(dk);
  zero(dv);
  for (int q0 = 0; q0 < p.seq; q0 += kRows) {
    __syncthreads();
    load_rows2_16<kD>(qs, dos, p.q + off, p.dout + off, ss, ss, q0, kRows, p.seq);
    for (int i = threadIdx.x; i < kRows; i += blockDim.x) {
      const bool in = q0 + i < p.seq;
      st_d[i] = in ? st[q0 + i] : 1.f;
      st_delta[i] = in ? st[plane + q0 + i] : 0.f;
    }
    __syncthreads();
    float s[NQ][4], dp[NQ][4];  // s^T = k q^T, dp^T = v do^T
    warp_abt<kD, NQ>(s, ks, qs, r0, g, t);
    warp_abt<kD, NQ>(dp, vs, dos, r0, g, t);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + r0 + 8 * (e >> 1);
        const int qi = j * 8 + 2 * t + (e & 1);
        const float ex = clipped_exp2(s[j][e] * p.scale_log2);
        const float pr = (key < p.seq && q0 + qi < p.seq) ? ex / st_d[qi] : 0.f;
        s[j][e] = pr;                               // p^T
        dp[j][e] = pr * (dp[j][e] - st_delta[qi]);  // ds^T
      }
    warp_fx<kD, NQ>(dv, s, dos, lane);
    warp_fx<kD, NQ>(dk, dp, qs, lane);
  }
  store_sum_bf16(p.out1 + off, p.acc1 + off, ss, dv, 1.f, k0 + r0, p.seq, t);
  store_sum_bf16(p.out2 + off, p.acc2 + off, ss, dk, p.scale, k0 + r0, p.seq, t);
}

// -------------------------------------------------------------- kernel #11

__global__ void __launch_bounds__(128) dots_probe_rows(ProbeParams p) {
  constexpr int LD = kD + 8, NT = kRows / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kRows * LD;
  __nv_bfloat16* ks = dos + kRows * LD;
  __nv_bfloat16* vs = ks + kRows * LD;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
  const long long ss = (long long)p.heads * kD;
  const long long off = b * p.seq * ss + h * kD;

  load_rows2_16<kD>(qs, dos, p.q + off, p.dout + off, ss, ss, q0, kRows, p.seq);
  float acc[kD / 8][4];  // o + dq
  zero(acc);
  for (int k0 = 0; k0 < p.seq; k0 += kRows) {
    __syncthreads();
    load_rows2_16<kD>(ks, vs, p.k + off, p.v + off, ss, ss, k0, kRows, p.seq);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    warp_abt<kD, NT>(s, qs, ks, r0, g, t);    // q k^T
    warp_abt<kD, NT>(dp, dos, vs, r0, g, t);  // do v^T
    warp_fx<kD, NT>(acc, s, vs, lane);        // + bf16(s) v
    warp_fx<kD, NT>(acc, dp, ks, lane);       // + bf16(dp) k
  }
  store_rows_f32(p.acc1 + off, ss, acc, q0 + r0, p.seq, t);
}

__global__ void __launch_bounds__(128) dots_probe_cols(ProbeParams p) {
  constexpr int LD = kD + 8, NQ = kRows / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kRows * LD;
  __nv_bfloat16* qs = vs + kRows * LD;
  __nv_bfloat16* dos = qs + kRows * LD;

  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
  const long long ss = (long long)p.heads * kD;
  const long long off = b * p.seq * ss + h * kD;

  load_rows2_16<kD>(ks, vs, p.k + off, p.v + off, ss, ss, k0, kRows, p.seq);
  float acc[kD / 8][4];  // dv + dk
  zero(acc);
  for (int q0 = 0; q0 < p.seq; q0 += kRows) {
    __syncthreads();
    load_rows2_16<kD>(qs, dos, p.q + off, p.dout + off, ss, ss, q0, kRows, p.seq);
    __syncthreads();
    float s[NQ][4], dp[NQ][4];
    warp_abt<kD, NQ>(s, ks, qs, r0, g, t);    // s^T = k q^T
    warp_abt<kD, NQ>(dp, vs, dos, r0, g, t);  // dp^T = v do^T
    warp_fx<kD, NQ>(acc, s, dos, lane);       // + bf16(s)^T do
    warp_fx<kD, NQ>(acc, dp, qs, lane);       // + bf16(dp)^T q
  }
  store_sum_bf16(p.out1 + off, p.acc1 + off, ss, acc, 1.f, k0 + r0, p.seq, t);
}

int launch_probe(void (*rows)(ProbeParams), void (*cols)(ProbeParams),
                 const ProbeParams& p, int batch, size_t cols_extra,
                 cudaStream_t stream) {
  const dim3 grid((p.seq + kRows - 1) / kRows, p.heads, batch);
  const size_t tiles = 4 * kRows * (kD + 8) * sizeof(__nv_bfloat16);
  int rc = launch(rows, p, grid, 128, tiles, stream);
  if (rc != 0) return rc;
  return launch(cols, p, grid, 128, tiles + cols_extra, stream);
}

ProbeParams params(const void* q, const void* k, const void* v,
                   const void* dout, int heads, int seq) {
  ProbeParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.out1 = p.out2 = nullptr;
  p.acc1 = p.acc2 = p.stats = nullptr;
  p.heads = heads;
  p.seq = seq;
  p.scale = 1.f;
  p.scale_log2 = kLog2e;
  return p;
}

}  // namespace

// q, k, v, dout, out1, out2: contiguous (B, S, H*64) bf16. acc1, acc2:
// (B, S, H*64) fp32 scratch; stats: 2 * B * H * S fp32 scratch. Two launches
// on `stream`. Returns 0, a cudaError_t code, or -1 for a head_dim other
// than 64.
extern "C" int vpt_attention_pairing_probe(
    const void* q, const void* k, const void* v, const void* dout, void* out1,
    void* out2, float* acc1, float* acc2, float* stats, int batch, int seq,
    int heads, int head_dim, float scale, void* stream) {
  if (head_dim != kD) return -1;
  ProbeParams p = params(q, k, v, dout, heads, seq);
  p.out1 = static_cast<__nv_bfloat16*>(out1);
  p.out2 = static_cast<__nv_bfloat16*>(out2);
  p.acc1 = acc1;
  p.acc2 = acc2;
  p.stats = stats;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return launch_probe(pairing_probe_rows, pairing_probe_cols, p, batch,
                      2 * kRows * sizeof(float),
                      static_cast<cudaStream_t>(stream));
}

// q, k, v, dout, out: contiguous (B, S, H*64) bf16; acc: (B, S, H*64) fp32
// scratch. Two launches on `stream`. Returns 0, a cudaError_t code, or -1
// for a head_dim other than 64.
extern "C" int vpt_attention_dots_probe(
    const void* q, const void* k, const void* v, const void* dout, void* out,
    float* acc, int batch, int seq, int heads, int head_dim, void* stream) {
  if (head_dim != kD) return -1;
  ProbeParams p = params(q, k, v, dout, heads, seq);
  p.out1 = static_cast<__nv_bfloat16*>(out);
  p.acc1 = acc;
  return launch_probe(dots_probe_rows, dots_probe_cols, p, batch, 0,
                      static_cast<cudaStream_t>(stream));
}
