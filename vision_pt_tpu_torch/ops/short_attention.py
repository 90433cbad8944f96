"""One-pass attention for short sequences on the packed (B, S, H*D) layout.

Port of ``vision_pt_tpu/ops/short_attention.py::short_attention_packed``
(forward). On a CUDA tensor :func:`short_attention_packed` launches the CUDA
kernel in ``csrc/short_attention.cu``; on a CPU tensor it runs the plain
PyTorch version :func:`short_attention_packed_reference`, which the tests hold
against the JAX kernel and which ``chip_smoke.py`` holds against the CUDA
kernel. The backward is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_SHORT_SEQ = 768
# Bounded-logits softmax: with QKNorm + RoPE the logits are bounded, so the
# max subtraction can go; the clip keeps exp2 finite and the row sum nonzero
# even if learned gains grow (exact softmax inside the clip).
BOUNDED_LOGIT_CLIP = 60.0
LOG2E = 1.4426950408889634
NEG_INF = -1e30
_DENOM_FLOOR = 2.0**-100

_KERNEL = "short_attention"
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load(_KERNEL).vpt_short_attention_packed_fwd
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll,
                       ctypes.c_float, i, i, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def short_attention_packed_reference(q, k, v, num_heads, kv_lens=None,
                                     scale=None, bounded=False):
    """Plain PyTorch version of the kernel: same arithmetic, (B, H, Sq, Sk)
    tensors. Products of the (exactly upcast) inputs accumulate in fp32, the
    unnormalised weights are rounded to v's dtype before the PV product, and
    the output is divided by the fp32 row sums."""
    batch, sq, width = q.shape
    sk = k.shape[1]
    dim = width // num_heads
    if scale is None:
        scale = dim**-0.5

    def heads(x):
        return x.reshape(batch, x.shape[1], num_heads, dim).transpose(1, 2)

    s = heads(q).float() @ heads(k).float().transpose(-1, -2)
    s = s * (scale * LOG2E)  # (B, H, Sq, Sk), exp2 domain
    if kv_lens is None:
        lens = torch.full((batch,), sk, device=q.device)
    else:
        lens = kv_lens.to(device=q.device, dtype=torch.int64).clamp(0, sk)
    valid = (torch.arange(sk, device=q.device)[None, :] < lens[:, None])
    valid = valid[:, None, None, :]
    if bounded:
        lim = BOUNDED_LOGIT_CLIP * LOG2E
        e = torch.exp2(s.clamp(-lim, lim))
    else:
        s = torch.where(valid, s, NEG_INF)
        e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    # masked weights are exactly 0, so a kv_len == 0 row gives 0 in both
    # modes (the floor keeps 0/0 out)
    e = torch.where(valid, e, 0.0)
    denom = e.sum(dim=-1, keepdim=True).clamp_min(_DENOM_FLOOR)
    o = (e.to(v.dtype).float() @ heads(v).float()) / denom
    return o.transpose(1, 2).reshape(batch, sq, width).to(q.dtype)


def _check(q, k, v, num_heads):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (B, S, H*D)")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel takes one of "
            "bfloat16, float32 for all three"
        )
    if q.shape[2] % num_heads or q.shape[2] // num_heads not in (64, 128):
        raise ValueError(
            f"head dim {q.shape[2] / num_heads}: the kernel takes 64 or 128"
        )
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    align = 16 if q.dtype == torch.bfloat16 else 4  # vector loads
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(2) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
        size = x.element_size()
        if (x.data_ptr() % align or (x.stride(0) * size) % align
                or (x.stride(1) * size) % align):
            raise ValueError(f"{name}: pointer and strides must be {align}-byte "
                             "aligned")


def short_attention_packed(q, k, v, num_heads, kv_lens=None, scale=None,
                           bounded=False):
    """(B, Sq, H*D) x (B, Sk, H*D) attention with suffix key padding
    ``kv_lens`` (B,); ``bounded=True`` takes the no-max softmax (only for
    bounded logits, e.g. QKNorm'd q/k). Launches the CUDA kernel for a CUDA
    tensor and raises if it cannot; a CPU tensor gets the plain version."""
    if q.device.type == "cpu":
        return short_attention_packed_reference(
            q, k, v, num_heads, kv_lens, scale, bounded
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, num_heads)
    batch, sq, width = q.shape
    sk = k.shape[1]
    dim = width // num_heads
    if scale is None:
        scale = dim**-0.5
    out = torch.empty((batch, sq, width), dtype=q.dtype, device=q.device)
    if batch == 0 or sq == 0:
        return out
    lens = None
    if kv_lens is not None:
        lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    rc = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr() if lens is not None else None,
        batch, sq, sk, num_heads, dim,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        float(scale), int(bool(bounded)), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"short_attention_packed kernel launch failed: {rc}")
    short_attention_packed.launches += 1
    return out


# launches of the CUDA kernel (not of the plain version) since the last reset
short_attention_packed.launches = 0
