// Short-sequence attention, forward, for Hopper (sm_90a): one C entry over
// the forward template of attention_fwd.cuh that serves kernel #1 (packed,
// bounded or not) and kernels #3 and #5 (the `short` backend, unbounded).
//
// vpt_short_attention_fwd replaces three Pallas TPU kernels of
// vision_pt_tpu/ops/short_attention.py. It computes their function, not
// their schedule:
//
//   o[b, i, h] = sum_j e[i, j] * v[b, j, h] / max(sum_j e[i, j], 2^-100)
//
// with per-batch suffix key lengths kv_lens (clamped to Sk; a row with kv_len
// 0 gives 0). Logits are scaled into the exp2 domain. bounded=1 clips them at
// +-60*log2(e) and exponentiates without max subtraction (exact softmax
// inside the clip: QKNorm bounds the logits); bounded=0 subtracts a running
// row max (online softmax across key tiles). The unnormalised weights are
// cast to v's type before the PV product, accumulation is fp32, and the
// (Sq, D) output is divided by the row sums at the end. Sq and Sk may differ.
// Given an `lse` buffer, it also writes each row's log-sum-exp, fp32 (B, H,
// Sq): log(max(sum_j e, 2^-100)) when bounded, max + log(sum_j e) when not
// (-1e30 on a row with no valid key); the backward (short_attention_bwd.cu)
// takes its probabilities from it. The wrapper passes it only when autograd
// will run the backward, so the sampler writes none.
//
//   #1  _fwd_kernel_packed, behind short_attention_packed: heads are D-wide
//       column slices of (B, S, H*D) tensors, bounded or not.
//   #3  _run_fwd (_fwd_kernel, one (b, h) program) and
//   #5  _run_fwd_ah (_fwd_kernel_ah, one program per batch element with the
//       heads unrolled), behind short_attention and short_attention_bhsd,
//       unbounded. Which of the two runs is a VMEM rule of the TPU
//       (_use_all_heads) and has no meaning here. At kv_len 0 the TPU kernels
//       give the mean of v over the block padded to 8; this one gives 0 (a
//       kept divergence).
//
// Layouts. The TPU path pads S to a multiple of 8 and transposes BSHD to
// BHSD around the call (_prep, _prep_bhsd); here the kernel reads every
// layout in place through the batch, row and head strides the wrapper
// passes: packed (B, S, H*D) and BSHD (B, S, H, D) have row stride H*D and
// head stride D, BHSD (B, H, S, D) row stride D and head stride S*D. Rows
// past S are loaded as zeros, so nothing is padded in memory.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense), q, k, v read and
// o written once, 4*B*H*S^2*D FLOPs:
//   JiT-B/16 256^2 sampler (#1: B 16 with CFG, S 266, H 12, D 64, bf16,
//   bounded): 26.1 MB -> 7.8 us against 3.48 GFLOP -> 3.5 us;
//   JiT-B/16 train shape (#1, #3, #5: B 64, S 298): 117 MB -> 35.0 us against
//   8.73 GFLOP -> 8.8 us;
// so the kernel is bound by memory: 0.0078 and 0.0350 ms per launch.
//
// Design. The TPU kernel keeps a whole (S, S) score tile in VMEM; here the
// forward of attention_fwd.cuh, which flash_attention.cu shares, streams K
// and V through a TMA ring of 64-key swizzled tiles up to kv_len, one
// warpgroup per (64 query rows, head, batch), with both products on wgmma.
// The TPU kernel's head pairing is not ported: it only fills the TPU's
// 128-deep matrix unit.

#include "attention_fwd.cuh"

using namespace vpt;

// dtype: 0 = bf16, 1 = fp32, 2 = fp16. Strides are in elements, (batch, row,
// head) for each tensor; the last dimension of every tensor is contiguous.
// `lse` is null or fp32 (B, H, Sq). Returns 0, a cudaError_t (or, for a
// refused tensor map, CUresult) code, or -1 for a head_dim/dtype pair this
// file has no kernel for.
extern "C" int vpt_short_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* kv_lens,
    int batch, int sq, int sk, int heads, int head_dim, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int bounded,
    int dtype, void* stream) {
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
  return bounded ? launch_fwd<true, false>(p, batch, head_dim, dtype, s)
                 : launch_fwd<false, false>(p, batch, head_dim, dtype, s);
}
