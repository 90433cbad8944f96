// Packed short-sequence attention, forward, for Hopper (sm_90a).
//
// Replaces vision_pt_tpu/ops/short_attention.py::_fwd_kernel_packed, the
// Pallas TPU kernel behind short_attention_packed (forward). It computes the
// same function, not the same schedule:
//
//   o[b, i, h] = sum_j e[i, j] * v[b, j, h] / max(sum_j e[i, j], 2^-100)
//
// over heads that live as D-wide column slices of (B, S, H*D) tensors (read
// in place through the strides the wrapper passes; no transposes), with
// per-batch suffix key lengths kv_lens (clamped to Sk; a row with kv_len 0
// gives 0). Logits are scaled into the exp2 domain. bounded=1 clips them at
// +-60*log2(e) and exponentiates without max subtraction (exact softmax
// inside the clip: QKNorm bounds the logits); bounded=0 subtracts a running
// row max (online softmax across key tiles). The unnormalised weights are
// cast to v's type before the PV product, accumulation is fp32, and the
// (Sq, D) output is divided by the row sums at the end.
//
// Bound at the JiT-B/16 256^2 sampler shape (B=16 rows with CFG, S=266,
// H=12, D=64, bf16, bounded, no kv_lens), on an H100 SXM:
//   bytes  q, k, v read and o written: 4 * 16*266*768*2 B = 26.1 MB
//          -> 26.1 MB / 3.35 TB/s = 7.8 us
//   FLOPs  4*B*H*S^2*D = 3.48 GFLOP -> 3.48 GFLOP / 989 TFLOP/s = 3.5 us
// so the kernel is bound by memory, at about 7.8 us per launch.
//
// Design (simple first). The TPU kernel keeps a whole (S, S) score tile in
// VMEM; here the forward of attention_fwd.cuh, which flash_attention.cu
// shares, streams K and V through shared memory in tiles of 64 keys up to
// kv_len, one thread block per (64 query rows, head, batch), with heads read
// as D-wide column slices (head stride D). The TPU kernel's head pairing is
// not ported: it only fills the TPU's 128-deep matrix unit. wgmma, TMA and a
// persistent schedule are left for later work.

#include "attention_fwd.cuh"

using namespace vpt;

// dtype: 0 = bf16, 1 = fp32. Strides are in elements; the last dimension of
// every tensor is contiguous. Returns 0, a cudaError_t code, or -1 for a
// head_dim/dtype pair this file has no kernel for.
extern "C" int vpt_short_attention_packed_fwd(
    const void* q, const void* k, const void* v, void* o, const int* kv_lens,
    int batch, int sq, int sk, int heads, int head_dim, long long q_sb,
    long long q_ss, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, long long o_sb, long long o_ss, float scale, int bounded,
    int dtype, void* stream) {
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = nullptr;
  p.kv_lens = kv_lens;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.q_sh = p.k_sh = p.v_sh = p.o_sh = head_dim;  // heads are column slices
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bounded ? launch_fwd<true, false>(p, batch, head_dim, dtype, s)
                 : launch_fwd<false, false>(p, batch, head_dim, dtype, s);
}
