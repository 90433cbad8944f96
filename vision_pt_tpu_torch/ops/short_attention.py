"""One-pass attention for short sequences (port of
``vision_pt_tpu/ops/short_attention.py``).

Three entry points, each a ``torch.autograd.Function`` whose forward saves
``(q, k, v, kv_lens, lse)`` when autograd will need them; the backward
recomputes the probabilities, in bf16 and fp16 from the lse (which the
forward then also writes), in fp32 from scratch as the JAX package's custom
VJPs do (the lse's rounding would exceed the fp32 tolerance; lse is None):

- :func:`short_attention_packed` on the packed (B, S, H*D) layout, bounded or
  not (kernels #1 and #2);
- :func:`short_attention` on (B, S, H, D) and :func:`short_attention_bhsd` on
  (B, H, S, D), the ``short`` backend (kernels #3-#6: unbounded softmax,
  suffix ``kv_lens``). The JAX package pads S to a multiple of 8 and
  transposes to BHSD for the TPU, and picks between two TPU schedules of one
  function by a VMEM rule (``_use_all_heads``); here one strided kernel reads
  either layout in place, so neither exists.

On a CUDA tensor the forwards launch the CUDA kernels in
``csrc/short_attention.cu`` and the backwards those in
``csrc/short_attention_bwd.cu``; on a CPU tensor every entry runs its plain
PyTorch version (the ``*_reference`` functions), which the tests hold against
the JAX kernels and which ``chip_smoke.py`` holds against the CUDA kernels.
A row with kv_len 0 gives exactly 0 and zero gradients in every entry.
Inputs are bfloat16, float16 or float32, as the JAX kernels are
dtype-generic; the 16-bit backwards take the lse of a ``*_with_lse``
forward, the fp32 ones ignore it (None will do).
"""

from __future__ import annotations

import array
import ctypes

import torch

from . import _build

MAX_SHORT_SEQ = 768
# Bounded-logits softmax: with QKNorm + RoPE the logits are bounded, so the
# max subtraction can go; the clip keeps exp2 finite and the row sum nonzero
# even if learned gains grow (exact softmax inside the clip).
BOUNDED_LOGIT_CLIP = 60.0
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30
_DENOM_FLOOR = 2.0**-100

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _kernel_fn(name: str):
    """The C entry point of ``csrc/<source>.cu`` for ``name`` ("fwd" or
    "bwd"), built and bound at first use: the forward lives in
    ``short_attention``, the backward in ``short_attention_bwd``."""
    if name not in _fns:
        ptr, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        if name == "fwd":
            fn = _build.load("short_attention").vpt_short_attention_fwd
            fn.argtypes = [*[ptr] * 6, i, i, i, i, i, *[ll] * 12, f, i, i, ptr]
        else:
            fn = _build.load("short_attention_bwd").vpt_short_attention_bwd
            fn.argtypes = [*[ptr] * 10, i, i, i, i, i, ptr, f, i, i, ptr]
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
                                     scale=None, bounded=False,
                                     return_lse=False):
    """Plain PyTorch version of the forward kernel: same arithmetic,
    (B, H, Sq, Sk) tensors. Products of the (exactly upcast) inputs
    accumulate in fp32, the unnormalised weights are rounded to v's dtype
    before the PV product, and the output is divided by the fp32 row sums.
    ``return_lse`` also returns the (B, H, Sq) row log-sum-exp the kernel
    writes: log(max(sum e, 2^-100)) when bounded, max + log(sum e) when not
    (-1e30 on a row with no valid key)."""
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
    total = e.sum(dim=-1, keepdim=True)
    denom = total.clamp_min(_DENOM_FLOOR)
    o = (e.to(v.dtype).to(acc) @ _split_heads(v, num_heads).to(acc)) / denom
    out = _merge_heads(o).to(q.dtype)
    if not return_lse:
        return out
    if bounded:
        lse = torch.log(denom)
    else:
        lse = torch.where(total > 0, s.amax(dim=-1, keepdim=True) * LN2
                          + torch.log(total.clamp_min(_DENOM_FLOOR)), NEG_INF)
    return out, lse[..., 0]


def short_attention_packed_bwd_reference(q, k, v, lse, do, num_heads,
                                         kv_lens=None, scale=None,
                                         bounded=False):
    """Plain PyTorch version of the backward kernels, ``_head_bwd``'s
    arithmetic: probabilities in fp32, for bf16 and fp16 inputs from the
    forward's (B, H, Sq) ``lse`` (``p = exp2(x - lse log2 e)``, x the logit
    in the exp2 domain, clipped when bounded: the forward's weights over
    their row sum), for fp32 (and fp64) inputs recomputed (bounded: clipped
    exp2, no max; unbounded: max-subtracted exp; ``lse`` is not read); ``p`` and ``ds`` rounded to
    the input dtype before their products, ``delta`` from fp32 ``p`` and
    ``dp``. ``do`` is cast to q's dtype first. Returns (dq, dk, dv) in q's
    dtype; a kv_len == 0 row gets zero grads in both modes."""
    batch, sq, width = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = (width // num_heads) ** -0.5
    dt, acc = q.dtype, _acc_dtype(q.dtype)
    qh, kh, vh, doh = (_split_heads(x.to(dt), num_heads).to(acc)
                       for x in (q, k, v, do))
    s = qh @ kh.transpose(-1, -2)
    valid = _key_valid(kv_lens, batch, sk, q.device)
    lim = BOUNDED_LOGIT_CLIP * LOG2E
    if dt.itemsize == 2:
        x = s * (scale * LOG2E)
        if bounded:
            x = x.clamp(-lim, lim)
        p = torch.where(valid, torch.exp2(x - lse.to(acc)[..., None] * LOG2E), 0.0)
    else:
        if bounded:
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


def _head_views(num_heads, *tensors):
    """(B, S, H, D) views of packed (B, S, H*D) tensors; raises on tensors
    that are not 3-D or whose width does not split into ``num_heads``."""
    if any(x.dim() != 3 for x in tensors):
        raise ValueError("q, k, v must be (B, S, H*D)")
    if any(x.shape[2] % num_heads for x in tensors):
        raise ValueError(f"widths {[x.shape[2] for x in tensors]} do not split "
                         f"into {num_heads} heads")
    return [x.view(x.shape[0], x.shape[1], num_heads, x.shape[2] // num_heads)
            for x in tensors]


def _device_lens(kv_lens, device):
    if kv_lens is None:
        return None
    return kv_lens.to(device=device, dtype=torch.int32).contiguous()


def _ptr(x):
    return x.data_ptr() if x is not None else None


def _lse_used(q):
    """True where the backward reads the forward's lse: bf16 and fp16."""
    return q.element_size() == 2


def _wants_kernel(q):
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); raise for any other device."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return True


def _forward(q, k, v, num_heads, kv_lens, scale, bounded, want_lse):
    """(out, lse), lse None unless ``want_lse``: the kernel for a CUDA
    tensor, the plain version for a CPU one."""
    if not _wants_kernel(q):
        ref = short_attention_packed_reference(
            q, k, v, num_heads, kv_lens, scale, bounded, return_lse=want_lse
        )
        return ref if want_lse else (ref, None)
    out, lse = _strided_forward(*_head_views(num_heads, q, k, v), kv_lens,
                                scale, bounded, want_lse, short_attention_packed)
    return out.view(q.shape), lse


def short_attention_packed_with_lse(q, k, v, num_heads, kv_lens=None,
                                    scale=None, bounded=False):
    """The forward of :func:`short_attention_packed` with its (B, H, Sq)
    fp32 row log-sum-exp, for an explicit :func:`short_attention_packed_bwd`
    (not differentiable; launches count as the forward's)."""
    return _forward(q, k, v, num_heads, kv_lens, scale, bounded, True)


def short_attention_packed_bwd(q, k, v, lse, do, num_heads, kv_lens=None,
                               scale=None, bounded=False):
    """(dq, dk, dv) of :func:`short_attention_packed` for the output
    cotangent ``do``, from the forward's ``lse``. Launches the CUDA backward
    (its dq and dk/dv kernels) for a CUDA tensor and raises if it cannot; a
    CPU tensor gets the plain version."""
    if not _wants_kernel(q):
        return short_attention_packed_bwd_reference(
            q, k, v, lse, do, num_heads, kv_lens, scale, bounded
        )
    grads = _strided_backward(*_head_views(num_heads, q, k, v, do), lse,
                              kv_lens, scale, bounded, short_attention_packed_bwd)
    return tuple(g.view(x.shape) for g, x in zip(grads, (q, k, v)))


class _PackedAttention(torch.autograd.Function):
    """The JAX package's ``custom_vjp``: when a gradient will be needed the
    forward also writes the row log-sum-exp and saves (q, k, v, kv_lens,
    lse); the backward recomputes the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, kv_lens, scale, bounded):
        needs_grad = any(ctx.needs_input_grad[:3])
        out, lse = _forward(q, k, v, num_heads, kv_lens, scale, bounded,
                            needs_grad and _lse_used(q))
        if needs_grad:
            ctx.save_for_backward(q, k, v, kv_lens, lse)
        ctx.args = (num_heads, scale, bounded)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_lens, lse = ctx.saved_tensors
        num_heads, scale, bounded = ctx.args
        dq, dk, dv = short_attention_packed_bwd(
            q, k, v, lse, dout, num_heads, kv_lens, scale, bounded
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


# --------------------------------------------- the ``short`` backend (#3-#6)
#
# (B, S, H, D) and (B, H, S, D) are one function over two layouts. Inside,
# every tensor is a BSHD view (the BHSD entry transposes its arguments, a
# view), and the kernels read it through its (batch, row, head) strides.


def _packed(x):
    """(B, S, H*D) of a (B, S, H, D) tensor."""
    return x.reshape(x.shape[0], x.shape[1], x.shape[2] * x.shape[3])


def short_attention_reference(q, k, v, kv_lens=None, scale=None,
                              return_lse=False):
    """Plain PyTorch version of the ``short`` forward on (B, S, H, D): the
    unbounded case of :func:`short_attention_packed_reference` (max-subtracted
    exp2 softmax, weights rounded to v's dtype before the PV product, fp32
    accumulation), with its (B, H, Sq) lse when ``return_lse``."""
    res = short_attention_packed_reference(
        _packed(q), _packed(k), _packed(v), q.shape[2], kv_lens, scale,
        bounded=False, return_lse=return_lse,
    )
    out = res[0] if return_lse else res
    out = out.reshape(q.shape)
    return (out, res[1]) if return_lse else out


def short_attention_bwd_reference(q, k, v, lse, do, kv_lens=None, scale=None):
    """Plain PyTorch version of the ``short`` backward on (B, S, H, D), from
    the forward's ``lse``: (dq, dk, dv) in q's dtype, ``do`` cast to q's
    dtype first."""
    grads = short_attention_packed_bwd_reference(
        _packed(q), _packed(k), _packed(v), lse, _packed(do), q.shape[2],
        kv_lens, scale, bounded=False,
    )
    return tuple(g.reshape(x.shape) for g, x in zip(grads, (q, k, v)))


def short_attention_bhsd_reference(q, k, v, kv_lens=None, scale=None,
                                   return_lse=False):
    """:func:`short_attention_reference` on (B, H, S, D)."""
    res = short_attention_reference(*(x.transpose(1, 2) for x in (q, k, v)),
                                    kv_lens, scale, return_lse)
    if return_lse:
        return res[0].transpose(1, 2), res[1]
    return res.transpose(1, 2)


def short_attention_bhsd_bwd_reference(q, k, v, lse, do, kv_lens=None,
                                       scale=None):
    """:func:`short_attention_bwd_reference` on (B, H, S, D)."""
    grads = short_attention_bwd_reference(
        *(x.transpose(1, 2) for x in (q, k, v)), lse, do.transpose(1, 2),
        kv_lens, scale)
    return tuple(g.transpose(1, 2) for g in grads)


def _check_strided(q, *others):
    """Raise on what the strided kernels do not take: (B, S, H, D) views of
    one dtype (bfloat16, float16 or float32) and device, D 64 or 128, the
    others with q's batch, heads and D, each with a contiguous last dimension
    and 16-byte (16-bit types) or 4-byte (fp32) aligned pointer and
    strides."""
    tensors = (q, *others)
    if any(x.dim() != 4 for x in tensors):
        raise ValueError("q, k, v must be 4-D")
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
    if not all(_aligned(x) for x in tensors):
        raise ValueError(
            "the last dimension must be contiguous, and pointer and strides "
            "16-byte (bf16, fp16) or 4-byte (fp32) aligned"
        )


def _aligned(x):
    """A contiguous last dimension, and the pointer and the other strides
    aligned for the kernels' vector loads: 16 bytes for bf16 and fp16, 4 for
    fp32."""
    align = 16 if x.element_size() == 2 else 4
    size = x.element_size()
    return (x.stride(3) == 1 and x.data_ptr() % align == 0
            and all((x.stride(i) * size) % align == 0 for i in range(3)))


def _strides(*tensors):
    """(batch, row, head) strides of (B, S, H, D) views, flattened."""
    return [n for x in tensors for n in x.stride()[:3]]


def _strided_forward(q, k, v, kv_lens, scale, bounded, want_lse, counter):
    """Launch the forward kernel (#1, #3 or #5) on BSHD views: (out, lse),
    lse (B, H, Sq) fp32 when ``want_lse``, else None; ``counter`` is the
    entry whose launches it counts."""
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    _check_strided(q, k, v)
    batch, sq, heads, dim = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = dim**-0.5
    # an output with q's layout: BSHD, or the BSHD view of BHSD memory
    out = torch.empty_like(q)
    lse = (torch.empty((batch, heads, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if batch == 0 or sq == 0:
        return out, lse
    lens = _device_lens(kv_lens, q.device)
    rc = _kernel_fn("fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
        _ptr(lens),
        batch, sq, sk, heads, dim, *_strides(q, k, v, out), float(scale),
        int(bool(bounded)), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{counter.__name__} kernel launch failed: {rc}")
    counter.launches += 1
    return out, lse


def _strided_backward(q, k, v, do, lse, kv_lens, scale, bounded, counter):
    """Launch the backward kernels (#2, #4 or #6) on BSHD views, from the
    forward's (B, H, Sq) ``lse``; returns (dq, dk, dv) with the layouts of
    q, k, v."""
    if do.dtype != q.dtype:
        do = do.to(q.dtype)
    if k.shape != v.shape or do.shape != q.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do {tuple(do.shape)}"
        )
    if not _aligned(do):  # e.g. the expanded cotangent of a sum
        do = do.contiguous()
    _check_strided(q, k, v, do)
    batch, sq, heads, dim = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = dim**-0.5
    if not _lse_used(q):
        lse = None
    elif (lse is None or tuple(lse.shape) != (batch, heads, sq)
          or lse.dtype != torch.float32 or lse.device != q.device):
        raise ValueError(f"lse must be fp32 {(batch, heads, sq)} on {q.device}")
    else:
        lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if batch == 0 or sq == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty((3, batch, heads, sq), dtype=torch.float32, device=q.device)
    lens = _device_lens(kv_lens, q.device)
    strides = array.array("q", _strides(q, k, v, do, dq, dk, dv))  # int64
    rc = _kernel_fn("bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        _ptr(lse), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), _ptr(lens), batch, sq, sk, heads, dim,
        strides.buffer_info()[0],
        float(scale), int(bool(bounded)), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{counter.__name__} kernel launch failed: {rc}")
    counter.launches += 1
    return dq, dk, dv


def short_attention_bwd(q, k, v, lse, do, kv_lens=None, scale=None):
    """(dq, dk, dv) of :func:`short_attention` on (B, S, H, D) for the output
    cotangent ``do``, from the forward's (B, H, Sq) ``lse``. Launches the
    CUDA backward (kernel #4) for a CUDA tensor and raises if it cannot; a
    CPU tensor gets the plain version."""
    if not _wants_kernel(q):
        return short_attention_bwd_reference(q, k, v, lse, do, kv_lens, scale)
    return _strided_backward(q, k, v, do, lse, kv_lens, scale, False,
                             short_attention_bwd)


def short_attention_bhsd_bwd(q, k, v, lse, do, kv_lens=None, scale=None):
    """(dq, dk, dv) of :func:`short_attention_bhsd` on (B, H, S, D): kernel
    #6 for a CUDA tensor (raises if it cannot), the plain version for a CPU
    tensor."""
    if not _wants_kernel(q):
        return short_attention_bhsd_bwd_reference(q, k, v, lse, do, kv_lens,
                                                  scale)
    q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
    grads = _strided_backward(q, k, v, do, lse, kv_lens, scale, False,
                              short_attention_bhsd_bwd)
    return tuple(g.transpose(1, 2) for g in grads)


def _short_forward(q, k, v, kv_lens, scale, want_lse, bhsd):
    """(out, lse) of the ``short`` forward on (B, S, H, D), or on (B, H, S,
    D) when ``bhsd``; lse None unless ``want_lse``."""
    if not _wants_kernel(q):
        reference = short_attention_bhsd_reference if bhsd else short_attention_reference
        res = reference(q, k, v, kv_lens, scale, return_lse=want_lse)
        return res if want_lse else (res, None)
    if not bhsd:
        return _strided_forward(q, k, v, kv_lens, scale, False, want_lse,
                                short_attention)
    out, lse = _strided_forward(*(x.transpose(1, 2) for x in (q, k, v)),
                                kv_lens, scale, False, want_lse,
                                short_attention_bhsd)
    return out.transpose(1, 2), lse


def short_attention_with_lse(q, k, v, kv_lens=None, scale=None):
    """The forward of :func:`short_attention` with its (B, H, Sq) fp32 row
    log-sum-exp, for an explicit :func:`short_attention_bwd` (not
    differentiable; launches count as the forward's)."""
    return _short_forward(q, k, v, kv_lens, scale, True, False)


def short_attention_bhsd_with_lse(q, k, v, kv_lens=None, scale=None):
    """:func:`short_attention_with_lse` on (B, H, S, D), for an explicit
    :func:`short_attention_bhsd_bwd`."""
    return _short_forward(q, k, v, kv_lens, scale, True, True)


class _ShortAttention(torch.autograd.Function):
    """The JAX package's ``custom_vjp`` of ``short_attention`` /
    ``short_attention_bhsd``: when a gradient will be needed the forward
    also writes the row log-sum-exp and saves (q, k, v, kv_lens, lse); the
    backward recomputes the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, scale, bhsd):
        needs_grad = any(ctx.needs_input_grad[:3])
        out, lse = _short_forward(q, k, v, kv_lens, scale,
                                  needs_grad and _lse_used(q), bhsd)
        if needs_grad:
            ctx.save_for_backward(q, k, v, kv_lens, lse)
        ctx.args = (scale, bhsd)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_lens, lse = ctx.saved_tensors
        scale, bhsd = ctx.args
        backward = short_attention_bhsd_bwd if bhsd else short_attention_bwd
        dq, dk, dv = backward(q, k, v, lse, dout, kv_lens, scale)
        return dq, dk, dv, None, None, None


def short_attention(q, k, v, kv_lens=None, scale=None):
    """(B, Sq, H, D) x (B, Sk, H, D) attention with suffix key padding
    ``kv_lens`` (B,); ``scale`` defaults to D^-0.5. Differentiable: the
    backward is :func:`short_attention_bwd`. Launches the CUDA kernels
    (#3, #4) for CUDA tensors and raises if it cannot; CPU tensors get the
    plain versions."""
    return _ShortAttention.apply(q, k, v, kv_lens, scale, False)


def short_attention_bhsd(q, k, v, kv_lens=None, scale=None):
    """:func:`short_attention` on (B, H, S, D) tensors, read in place (no
    transposes in memory): kernels #5 and #6 on the card."""
    return _ShortAttention.apply(q, k, v, kv_lens, scale, True)


# launches of the CUDA kernels (not of the plain versions) since the last reset
short_attention.launches = 0
short_attention_bwd.launches = 0
short_attention_bhsd.launches = 0
short_attention_bhsd_bwd.launches = 0
