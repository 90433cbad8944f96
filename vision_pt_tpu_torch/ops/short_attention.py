"""One-pass attention for short sequences on the packed (B, S, H*D) layout.

Port of ``vision_pt_tpu/ops/short_attention.py::short_attention_packed`` and
its custom VJP. :func:`short_attention_packed` is a ``torch.autograd.Function``
that saves ``(q, k, v, kv_lens)`` and recomputes the probabilities in the
backward, as the JAX package does. On a CUDA tensor the forward launches the
CUDA kernel in ``csrc/short_attention.cu`` and the backward the one in
``csrc/short_attention_bwd.cu``; on a CPU tensor both run their plain PyTorch
versions (:func:`short_attention_packed_reference`,
:func:`short_attention_packed_bwd_reference`), which the tests hold against
the JAX kernels and which ``chip_smoke.py`` holds against the CUDA kernels.
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

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _kernel_fn(name: str):
    """The C entry point ``name`` of ``csrc/<source>.cu``, built and bound
    at first use: the forward lives in ``short_attention``, the backward in
    ``short_attention_bwd``."""
    if name not in _fns:
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "fwd":
            fn = _build.load("short_attention").vpt_short_attention_packed_fwd
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i, i, i, i, i,
                           *[ll] * 8, ctypes.c_float, i, i, ptr]
        else:
            fn = _build.load("short_attention_bwd").vpt_short_attention_packed_bwd
            fn.argtypes = [*[ptr] * 9, i, i, i, i, i,
                           *[ll] * 14, ctypes.c_float, i, i, ptr]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 accumulation, or fp64 for fp64 inputs (gradient checks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _split_heads(x, num_heads):
    batch, seq, width = x.shape
    return x.reshape(batch, seq, num_heads, width // num_heads).transpose(1, 2)


def _merge_heads(x):
    batch, heads, seq, dim = x.shape
    return x.transpose(1, 2).reshape(batch, seq, heads * dim)


def _key_valid(kv_lens, batch, sk, device):
    """(B, 1, 1, Sk) mask of the keys below each row's clamped kv_len."""
    if kv_lens is None:
        lens = torch.full((batch,), sk, device=device)
    else:
        lens = kv_lens.to(device=device, dtype=torch.int64).clamp(0, sk)
    return (torch.arange(sk, device=device)[None, :] < lens[:, None])[:, None, None, :]


def short_attention_packed_reference(q, k, v, num_heads, kv_lens=None,
                                     scale=None, bounded=False):
    """Plain PyTorch version of the forward kernel: same arithmetic,
    (B, H, Sq, Sk) tensors. Products of the (exactly upcast) inputs
    accumulate in fp32, the unnormalised weights are rounded to v's dtype
    before the PV product, and the output is divided by the fp32 row sums."""
    batch, sq, width = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = (width // num_heads) ** -0.5
    acc = _acc_dtype(q.dtype)
    s = (_split_heads(q, num_heads).to(acc)
         @ _split_heads(k, num_heads).to(acc).transpose(-1, -2))
    s = s * (scale * LOG2E)  # (B, H, Sq, Sk), exp2 domain
    valid = _key_valid(kv_lens, batch, sk, q.device)
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
    o = (e.to(v.dtype).to(acc) @ _split_heads(v, num_heads).to(acc)) / denom
    return _merge_heads(o).to(q.dtype)


def short_attention_packed_bwd_reference(q, k, v, do, num_heads, kv_lens=None,
                                         scale=None, bounded=False):
    """Plain PyTorch version of the backward kernel, ``_head_bwd``'s
    arithmetic: probabilities recomputed in fp32 (bounded: clipped exp2, no
    max; unbounded: max-subtracted exp), ``p`` and ``ds`` rounded to the
    input dtype before their products, ``delta`` from fp32 ``p`` and ``dp``.
    ``do`` is cast to q's dtype first. Returns (dq, dk, dv) in q's dtype; a
    kv_len == 0 row gets zero grads in both modes."""
    batch, sq, width = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = (width // num_heads) ** -0.5
    dt, acc = q.dtype, _acc_dtype(q.dtype)
    qh, kh, vh, doh = (_split_heads(x.to(dt), num_heads).to(acc)
                       for x in (q, k, v, do))
    s = qh @ kh.transpose(-1, -2)
    valid = _key_valid(kv_lens, batch, sk, q.device)
    if bounded:
        lim = BOUNDED_LOGIT_CLIP * LOG2E
        e = torch.exp2((s * (scale * LOG2E)).clamp(-lim, lim))
    else:
        s = torch.where(valid, s * scale, NEG_INF)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    e = torch.where(valid, e, 0.0)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(_DENOM_FLOOR)
    dv = p.to(dt).to(acc).transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).to(acc)
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale
    return tuple(_merge_heads(x).to(dt) for x in (dq, dk, dv))


def _check(num_heads, q, *others):
    """Raise on what the kernels do not take: q is (B, Sq, H*D), the others
    (B, S, H*D) of one dtype and device, each with a contiguous last
    dimension and 16-byte (bf16) or 4-byte (fp32) aligned rows."""
    tensors = (q, *others)
    if any(x.dim() != 3 for x in tensors):
        raise ValueError("q, k, v must be (B, S, H*D)")
    if any(x.shape[0] != q.shape[0] or x.shape[2] != q.shape[2] for x in others):
        raise ValueError(
            "shape mismatch: " + " ".join(str(tuple(x.shape)) for x in tensors)
        )
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in others):
        raise ValueError(
            f"dtypes {[x.dtype for x in tensors]}: the kernel takes one of "
            "bfloat16, float32 for all"
        )
    if q.shape[2] % num_heads or q.shape[2] // num_heads not in (64, 128):
        raise ValueError(
            f"head dim {q.shape[2] / num_heads}: the kernel takes 64 or 128"
        )
    if any(x.device != q.device for x in others):
        raise ValueError("q, k, v must be on one device")
    align = 16 if q.dtype == torch.bfloat16 else 4  # vector loads
    for x in tensors:
        if x.stride(2) != 1:
            raise ValueError("the last dimension must be contiguous")
        size = x.element_size()
        if (x.data_ptr() % align or (x.stride(0) * size) % align
                or (x.stride(1) * size) % align):
            raise ValueError(f"pointer and strides must be {align}-byte aligned")


def _device_lens(kv_lens, device):
    if kv_lens is None:
        return None
    return kv_lens.to(device=device, dtype=torch.int32).contiguous()


def _ptr(x):
    return x.data_ptr() if x is not None else None


def _forward(q, k, v, num_heads, kv_lens, scale, bounded):
    if q.device.type == "cpu":
        return short_attention_packed_reference(
            q, k, v, num_heads, kv_lens, scale, bounded
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    _check(num_heads, q, k, v)
    batch, sq, width = q.shape
    sk = k.shape[1]
    dim = width // num_heads
    if scale is None:
        scale = dim**-0.5
    out = torch.empty((batch, sq, width), dtype=q.dtype, device=q.device)
    if batch == 0 or sq == 0:
        return out
    lens = _device_lens(kv_lens, q.device)
    rc = _kernel_fn("fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lens),
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


def short_attention_packed_bwd(q, k, v, do, num_heads, kv_lens=None,
                               scale=None, bounded=False):
    """(dq, dk, dv) of :func:`short_attention_packed` for the output
    cotangent ``do``. Launches the CUDA backward (its dq and dk/dv kernels)
    for a CUDA tensor and raises if it cannot; a CPU tensor gets the plain
    version."""
    if q.device.type == "cpu":
        return short_attention_packed_bwd_reference(
            q, k, v, do, num_heads, kv_lens, scale, bounded
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    do = do.to(q.dtype).contiguous()
    if k.shape != v.shape or do.shape != q.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do {tuple(do.shape)}"
        )
    _check(num_heads, q, k, v, do)
    batch, sq, width = q.shape
    sk = k.shape[1]
    dim = width // num_heads
    if scale is None:
        scale = dim**-0.5
    dq, dk, dv = (torch.empty(x.shape, dtype=q.dtype, device=q.device)
                  for x in (q, k, v))
    if batch == 0 or sq == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty((3, batch, num_heads, sq), dtype=torch.float32,
                        device=q.device)
    lens = _device_lens(kv_lens, q.device)
    rc = _kernel_fn("bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        _ptr(lens), batch, sq, sk, num_heads, dim,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), do.stride(0), do.stride(1),
        dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
        dv.stride(0), dv.stride(1),
        float(scale), int(bool(bounded)), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"short_attention_packed_bwd kernel launch failed: {rc}")
    short_attention_packed_bwd.launches += 1
    return dq, dk, dv


class _PackedAttention(torch.autograd.Function):
    """The JAX package's ``custom_vjp``: the forward saves (q, k, v,
    kv_lens); the backward recomputes the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, kv_lens, scale, bounded):
        ctx.save_for_backward(q, k, v, kv_lens)
        ctx.args = (num_heads, scale, bounded)
        return _forward(q, k, v, num_heads, kv_lens, scale, bounded)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_lens = ctx.saved_tensors
        num_heads, scale, bounded = ctx.args
        dq, dk, dv = short_attention_packed_bwd(
            q, k, v, dout, num_heads, kv_lens, scale, bounded
        )
        return dq, dk, dv, None, None, None, None


def short_attention_packed(q, k, v, num_heads, kv_lens=None, scale=None,
                           bounded=False):
    """(B, Sq, H*D) x (B, Sk, H*D) attention with suffix key padding
    ``kv_lens`` (B,); ``bounded=True`` takes the no-max softmax (only for
    bounded logits, e.g. QKNorm'd q/k). Differentiable: the backward is
    :func:`short_attention_packed_bwd`. Launches the CUDA kernels for CUDA
    tensors and raises if it cannot; CPU tensors get the plain versions."""
    return _PackedAttention.apply(q, k, v, num_heads, kv_lens, scale, bounded)


# launches of the CUDA kernels (not of the plain versions) since the last reset
short_attention_packed.launches = 0
short_attention_packed_bwd.launches = 0
