// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces vision_pt_tpu/ops/flash_attention.py::_flash_forward (its Pallas
// TPU kernel _fwd_kernel), the forward of flash_attention. It computes the
// same function, not the same schedule:
//
//   s[i, j]   = q[b, i, h] . k[b, j, h] * scale      (fp32 accumulate)
//   valid     = j < kv_len[b]  (and j <= i when causal)
//   o[b, i, h] = sum_j e[i, j] v[b, j, h] / sum_j e[i, j],
//   e[i, j]   = exp(s[i, j] - max_j s[i, j]) on the valid set, else 0
//   lse[b, h, i] = max_j s + log(sum_j e)
//
// over (B, S, H, D) tensors read in place through the (batch, row, head)
// strides the wrapper passes (no transposes), with kv_lens clamped to Sk. A
// row with no valid key gives o = 0 and lse = -1e30. The online softmax runs
// in the exp2 domain; the weights are rounded to v's type before the PV
// product; o is in the inputs' type, lse fp32 (B, H, Sq).
//
// Bound at the latent JiT 1024^2 training shape (B = 16, S = 4170, H = 12,
// D = 64, bf16, kv_lens near S), on an H100 SXM:
//   FLOPs  4 * B * H * S^2 * D = 8.5e11 -> / 989 TFLOP/s = 0.86 ms
//   bytes  q, k, v read and o written: 4 * 16*4170*768*2 B = 0.41 GB
//          -> / 3.35 TB/s = 0.12 ms
// so the kernel is bound by the tensor cores, at about 0.86 ms per call.
//
// Design. The TPU kernel runs 1024 x 1024 blocks with a sequential key axis
// and VMEM scratch; a block on Hopper has 227 KB of shared memory and blocks
// run in no order. So the forward of attention_fwd.cuh, which
// short_attention.cu shares, gives each warpgroup 64 query rows of one
// (head, batch) and the whole key loop: Q stays in a swizzled shared-memory
// tile, K and V stream through a TMA ring (tiles wholly past kv_len, or
// wholly above the diagonal when causal, are never loaded), s = Q K^T
// and o += P V run as wgmma with the online max and sum in registers, and
// the LSE is written beside o. From Sk 1024 on (the latent trainer, SDXL's
// self-attentions) the key tiles are kFwdKeysLong wide. fp16 inputs take
// the bf16 kernel's template; fp32 inputs a scalar FMA kernel (one thread
// per query row).

#include "attention_fwd.cuh"

using namespace vpt;

// dtype: 0 = bf16, 1 = fp32, 2 = fp16. Strides are in elements, (batch, row,
// head) for each of q, k, v, o; the last dimension of every tensor is
// contiguous. Returns 0, a cudaError_t (or, for a refused tensor map,
// CUresult) code, or -1 for a head_dim/dtype pair this file has no kernel
// for.
extern "C" int vpt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* kv_lens, int batch, int sq, int sk, int heads, int head_dim,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int dtype, void* stream) {
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
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
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? launch_fwd<false, true>(p, batch, head_dim, dtype, s)
                : launch_fwd<false, false>(p, batch, head_dim, dtype, s);
}
