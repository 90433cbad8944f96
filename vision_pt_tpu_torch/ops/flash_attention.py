"""Flash attention (forward and backward) with suffix key padding.

Port of ``vision_pt_tpu/ops/flash_attention.py``. The public layout is
(B, S, H, D), as in the JAX package. :func:`flash_attention` is a
``torch.autograd.Function`` that saves ``(q, k, v, kv_lens, out, lse)``, as the
JAX custom VJP does. On a CUDA tensor the forward launches the CUDA kernel in
``csrc/flash_attention.cu`` and the backward the two kernels in
``csrc/flash_attention_bwd.cu``; on a CPU tensor both run their plain PyTorch
versions (:func:`flash_attention_reference`,
:func:`flash_attention_bwd_reference`), which the tests hold against the JAX
kernels and which ``chip_smoke.py`` holds against the CUDA kernels.

Semantics kept from the JAX package: ``kv_lens=None`` means Sk and
``kv_lens`` is clipped to Sk; masked logits are -1e30 and their weights 0; a
row with kv_len 0 gives output 0, an LSE of -1e30 and zero gradients; causal
is ``col <= row`` with rows and columns counted from 0 in their own
sequences; the output is in q's dtype and the LSE (B, H, Sq) is fp32. The
backward takes ``delta = rowsum(do * out)`` in fp32 from the stored output,
rounds ``p`` to v's dtype before the dV product and
``ds = p * (dp - delta) * scale`` to q's dtype before the dQ and dK products.
Padding to blocks is the TPU's business: the kernels mask ragged edges
themselves and return exactly (B, Sq, H, D).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .short_attention import _acc_dtype, _device_lens, _ptr

NEG_INF = -1e30
_LSE_FLOOR = 1e-37

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _kernel_fn(name: str):
    """The C entry point of ``csrc/flash_attention.cu`` (``fwd``) or
    ``csrc/flash_attention_bwd.cu`` (``bwd``), built and bound at first use."""
    if name not in _fns:
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "fwd":
            fn = _build.load("flash_attention").vpt_flash_attention_fwd
            fn.argtypes = [*[ptr] * 6, i, i, i, i, i, *[ll] * 12,
                           ctypes.c_float, i, i, ptr]
        else:
            fn = _build.load("flash_attention_bwd").vpt_flash_attention_bwd
            fn.argtypes = [*[ptr] * 11, i, i, i, i, i, *[ll] * 24,
                           ctypes.c_float, i, i, ptr]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _valid(kv_lens, batch, sq, sk, causal, device):
    """(B, 1, Sq, Sk) mask of the keys each query row may attend."""
    if kv_lens is None:
        lens = torch.full((batch,), sk, device=device)
    else:
        lens = kv_lens.to(device=device, dtype=torch.int64).clamp(0, sk)
    col = torch.arange(sk, device=device)
    valid = (col[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        row = torch.arange(sq, device=device)
        valid = valid & (col[None, :] <= row[:, None])[None, None]
    return valid


def _logits(q, k, scale):
    """(B, H, Sq, Sk) scaled scores, accumulated in fp32 (fp64 for fp64)."""
    acc = _acc_dtype(q.dtype)
    return torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale


def flash_attention_reference(q, k, v, kv_lens=None, *, scale=None,
                              causal=False):
    """Plain PyTorch version of the forward kernel: (out, lse). The weights
    ``exp(s - rowmax)`` are rounded to v's dtype before the PV product, the
    output is divided by the fp32 row sums (a row with no valid key gives 0),
    and ``lse = rowmax + log(max(rowsum, 1e-37))``."""
    batch, sq, _, dim = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = dim**-0.5
    acc = _acc_dtype(q.dtype)
    valid = _valid(kv_lens, batch, sq, sk, causal, q.device)
    s = torch.where(valid, _logits(q, k, scale), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)  # -1e30 on a row with no valid key
    e = torch.where(valid, torch.exp(s - m), 0.0)
    denom = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).to(acc), v.to(acc))
    out = out / torch.where(denom == 0, 1.0, denom).permute(0, 2, 1, 3)
    lse = (m + torch.log(denom.clamp_min(_LSE_FLOOR)))[..., 0]
    return out.to(q.dtype), lse.to(acc)


def flash_attention_bwd_reference(q, k, v, out, lse, do, kv_lens=None, *,
                                  scale=None, causal=False):
    """Plain PyTorch version of the backward kernels, ``_flash_backward``'s
    arithmetic: ``delta`` in fp32 from ``do`` and the stored ``out``,
    ``p = exp(s - lse)`` on the valid set, ``p`` rounded to v's dtype before
    the dV product, ``ds = p * (dp - delta) * scale`` rounded to q's dtype
    before the dQ and dK products. ``do`` is cast to q's dtype first.
    Returns (dq, dk, dv) in q's dtype."""
    batch, sq, _, dim = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = dim**-0.5
    dt, acc = q.dtype, _acc_dtype(q.dtype)
    do = do.to(dt)
    delta = torch.einsum("bqhd,bqhd->bhq", do.to(acc), out.to(acc))
    valid = _valid(kv_lens, batch, sq, sk, causal, q.device)
    s = _logits(q, k, scale)
    p = torch.where(valid, torch.exp(s - lse.to(acc)[..., None]), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).to(acc), do.to(acc))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(acc), v.to(acc))
    ds = (p * (dp - delta[..., None]) * scale).to(dt).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc))
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check(q, *others):
    """Raise on what the kernels do not take: (B, S, H, D) tensors of one
    dtype (bf16, fp16 or fp32) and device, D 64 or 128, a contiguous last
    dimension and 16-byte (bf16, fp16) or 4-byte (fp32) aligned rows and
    heads."""
    tensors = (q, *others)
    if any(x.dim() != 4 for x in tensors):
        raise ValueError("q, k, v must be (B, S, H, D)")
    if any(x.shape[0] != q.shape[0] or x.shape[2:] != q.shape[2:] for x in others):
        raise ValueError(
            "shape mismatch: " + " ".join(str(tuple(x.shape)) for x in tensors)
        )
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in others):
        raise ValueError(
            f"dtypes {[x.dtype for x in tensors]}: the kernel takes one of "
            "bfloat16, float16, float32 for all"
        )
    if q.shape[3] not in (64, 128):
        raise ValueError(f"head dim {q.shape[3]}: the kernel takes 64 or 128")
    if any(x.device != q.device for x in others):
        raise ValueError("q, k, v must be on one device")
    align = 16 if q.element_size() == 2 else 4  # vector loads
    for x in tensors:
        if x.stride(3) != 1:
            raise ValueError("the last dimension must be contiguous")
        size = x.element_size()
        if x.data_ptr() % align or any((x.stride(i) * size) % align
                                       for i in range(3)):
            raise ValueError(f"pointer and strides must be {align}-byte aligned")


def _strides(*tensors):
    return [s for x in tensors for s in (x.stride(0), x.stride(1), x.stride(2))]


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _forward(q, k, v, kv_lens, scale, causal):
    """(out, lse): the CUDA kernel for CUDA tensors, else the plain version."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_lens, scale=scale,
                                         causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    _check(q, k, v)
    batch, sq, heads, dim = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = dim**-0.5
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((batch, heads, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse.fill_(NEG_INF)
    lens = _device_lens(kv_lens, q.device)
    rc = _kernel_fn("fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _ptr(lens), batch, sq, sk, heads, dim,
        *_strides(q, k, v, out), float(scale), int(bool(causal)),
        _DTYPE_CODES[q.dtype], _stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {rc}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, do, kv_lens=None, *, scale=None,
                        causal=False):
    """(dq, dk, dv) of :func:`flash_attention` for the output cotangent
    ``do``, from the forward's ``out`` and ``lse``. Launches the CUDA backward
    (its dq and dk/dv kernels) for a CUDA tensor and raises if it cannot; a
    CPU tensor gets the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do, kv_lens,
                                             scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    do = do.to(q.dtype)
    if k.shape != v.shape or do.shape != q.shape or out.shape != q.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} out {tuple(out.shape)} do {tuple(do.shape)}"
        )
    _check(q, k, v, out, do)
    batch, sq, heads, dim = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = dim**-0.5
    if lse.shape != (batch, heads, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 {(batch, heads, sq)}")
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty(x.shape, dtype=q.dtype, device=q.device)
                  for x in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((batch, heads, sq), dtype=torch.float32, device=q.device)
    lens = _device_lens(kv_lens, q.device)
    rc = _kernel_fn("bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), _ptr(lens),
        batch, sq, sk, heads, dim, *_strides(q, k, v, out, do, dq, dk, dv),
        float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype], _stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``custom_vjp``: the forward saves (q, k, v, kv_lens,
    out, lse); the backward is :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, scale, causal):
        out, lse = _forward(q, k, v, kv_lens, scale, causal)
        ctx.save_for_backward(q, k, v, kv_lens, out, lse)
        ctx.args = (scale, causal)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, kv_lens, out, lse = ctx.saved_tensors
        scale, causal = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, kv_lens,
                                         scale=scale, causal=causal)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q, k, v, kv_lens=None, *, scale=None,
                             causal=False):
    """:func:`flash_attention` that also returns the (B, H, Sq) fp32 LSE (not
    differentiable)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, kv_lens, float(scale), bool(causal))


def flash_attention(q, k, v, kv_lens=None, *, scale=None, causal=False):
    """(B, Sq, H, D) x (B, Sk, H, D) attention with suffix key padding
    ``kv_lens`` (B,) and optional causal masking; the output is in q's dtype.
    Differentiable: the backward is :func:`flash_attention_bwd`. Launches
    the CUDA kernels for CUDA tensors and raises if it cannot; CPU tensors
    get the plain versions."""
    return flash_attention_with_lse(q, k, v, kv_lens, scale=scale,
                                    causal=causal)[0]


# launches of the CUDA kernels (not of the plain versions) since the last reset
flash_attention.launches = 0
flash_attention_bwd.launches = 0
