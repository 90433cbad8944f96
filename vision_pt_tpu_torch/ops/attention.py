"""Attention dispatch (port of the part of ``vision_pt_tpu/ops/attention.py``
that the JiT sampler and training paths and the SDXL UNet use).

Layout is (B, S, H, D) throughout, as in the JAX package. fp32 q/k/v are cast
to the attention dtype (default bf16) first. The ``xla`` backend (and
``eager``, ``sdpa``) is ``xla_attention_remat`` in plain PyTorch: fp32
logits, ``finfo(float32).min`` masking, weights
``exp(logits - logsumexp(logits))`` rounded to v's dtype before the PV
product. Its backward saves only ``(out, lse)`` and recomputes the
probabilities, as the JAX package's custom VJP does, so no (B, H, S, S)
tensor lives from the forward to the backward. The ``flash`` backend is
``ops.flash_attention`` (CUDA kernels on the card, plain versions on the
CPU); ``auto`` picks it on the card for long unmasked sequences, as the JAX
package does on the TPU. The ``short`` backend is
``ops.short_attention.short_attention`` (kernels #3/#4 on the card, plain
versions on the CPU; suffix ``kv_lens`` only); ``auto`` never picks it, as in
the JAX package. Inside ``sequence_parallel(mesh)`` an eligible
self-attention (no mask, not causal, Sq == Sk divisible by the seq axis)
under ``auto`` or ``ring`` goes round the seq ranks
(``ops.ring_attention``); ``ring`` outside it raises.
"""

from __future__ import annotations

import contextlib
from typing import Literal

import torch

from .flash_attention import flash_attention
from .short_attention import short_attention

AttentionImplementation = Literal[
    "auto", "flash", "short", "xla", "eager", "sdpa", "ring"
]

_DEFAULT_ATTENTION_DTYPE: torch.dtype | None = torch.bfloat16
_SENTINEL = object()

# Gate of the flash kernels, kept at the JAX package's value. It was tuned on
# a TPU and is not yet measured on an H100.
MIN_FLASH_SEQ = 1024


def _on_cuda(x: torch.Tensor) -> bool:
    """Where the flash kernels can run (the JAX gate's ``_on_tpu()``)."""
    return x.is_cuda


# ---------------------------------------------------------------- seq parallel
# The active (mesh, seq axis, batch axes) while ``sequence_parallel`` is
# entered: eligible self-attention then goes round the seq ranks.
_SEQ_PARALLEL: tuple[object, str, tuple[str, ...]] | None = None
# calls that took the ring, so a test can see the path was taken (a silent
# fallback would give the same numbers)
_RING_DISPATCH_COUNT = 0


@contextlib.contextmanager
def sequence_parallel(mesh, axis_name: str = "seq",
                      batch_axes: tuple[str, ...] = ("data", "fsdp")):
    """Scoped ring-attention dispatch over ``mesh`` (a ``DeviceMesh``); a
    no-op when its seq axis has one rank. ``batch_axes`` names the axes the
    batch rows are already split over (the trainer's ``shard_batch``)."""
    global _SEQ_PARALLEL
    prev = _SEQ_PARALLEL
    names = mesh.mesh_dim_names or ()
    if axis_name in names and mesh[axis_name].size() > 1:
        _SEQ_PARALLEL = (mesh, axis_name, tuple(a for a in batch_axes if a in names))
    try:
        yield
    finally:
        _SEQ_PARALLEL = prev


def get_sequence_parallel():
    """The active (mesh, axis_name, batch_axes), or None."""
    return _SEQ_PARALLEL


def ring_dispatch_count() -> int:
    """How many attention calls took the ring so far (process-global; take a
    before / after difference)."""
    return _RING_DISPATCH_COUNT


def _ring_eligible(q, k, mask, is_causal, n: int) -> bool:
    return (mask is None and not is_causal and q.shape[1] == k.shape[1]
            and q.shape[1] % n == 0)


def set_default_attention_dtype(dtype: torch.dtype | None) -> None:
    global _DEFAULT_ATTENTION_DTYPE
    _DEFAULT_ATTENTION_DTYPE = dtype


def get_default_attention_dtype() -> torch.dtype | None:
    return _DEFAULT_ATTENTION_DTYPE


@contextlib.contextmanager
def attention_dtype(dtype: torch.dtype | None):
    """Scoped override of the default attention compute dtype (parity runs
    use ``attention_dtype(None)`` to stay fp32)."""
    prev = get_default_attention_dtype()
    set_default_attention_dtype(dtype)
    try:
        yield
    finally:
        set_default_attention_dtype(prev)


@contextlib.contextmanager
def _exact_tf32(inputs_dtype: torch.dtype, device: torch.device):
    """Let a CUDA fp32 matmul use TF32 when its operands were upcast from
    bf16/fp16: TF32 holds those values and their products exactly, so the
    result is the low-precision product with fp32 accumulation, at tensor-core
    speed. Native fp32 operands keep full fp32."""
    if device.type != "cuda" or inputs_dtype not in (torch.bfloat16, torch.float16):
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _masked_logits(q, k, mask, kv_lens, scale, is_causal):
    sq, sk = q.shape[1], k.shape[1]
    with _exact_tf32(q.dtype, q.device):
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    neg = torch.finfo(torch.float32).min
    if kv_lens is not None:
        key_valid = (
            torch.arange(sk, device=q.device)[None, :]
            < kv_lens.to(q.device)[:, None]
        )
        logits = logits.masked_fill(~key_valid[:, None, None, :], neg)
    if mask is not None:
        if mask.dim() == 2:  # (B, Sk) key padding
            mask = mask[:, None, None, :]
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, neg)
        else:  # additive bias
            logits = logits + mask.float()
    if is_causal:
        causal = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~causal, neg)
    return logits


def _attention_forward(q, k, v, mask, kv_lens, scale, is_causal):
    logits = _masked_logits(q, k, mask, kv_lens, scale, is_causal)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)  # (B, H, Sq, 1)
    weights = torch.exp(logits - lse).to(v.dtype)
    with _exact_tf32(v.dtype, v.device):
        out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())
    return out.to(v.dtype), lse


def _low_precision_product(equation, a, b, dtype):
    """einsum of two tensors of ``dtype`` with fp32 accumulation, rounded to
    ``dtype`` (the JAX package's einsum of two bf16 arrays)."""
    with _exact_tf32(dtype, a.device):
        return torch.einsum(equation, a.float(), b.float()).to(dtype)


class _RematAttention(torch.autograd.Function):
    """``xla_attention_remat``: the forward saves (q, k, v, mask, kv_lens,
    out, lse); the backward (``_attn_remat_bwd``) recomputes the fp32
    probabilities, rounds ``p`` and ``ds`` to the input dtype before their
    products, takes ``delta`` from ``dout . out`` in fp32, and returns the
    gradient of an additive mask."""

    @staticmethod
    def forward(ctx, q, k, v, mask, kv_lens, scale, is_causal):
        out, lse = _attention_forward(q, k, v, mask, kv_lens, scale, is_causal)
        ctx.save_for_backward(q, k, v, mask, kv_lens, out, lse)
        ctx.args = (scale, is_causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, kv_lens, out, lse = ctx.saved_tensors
        scale, is_causal = ctx.args
        logits = _masked_logits(q, k, mask, kv_lens, scale, is_causal)
        p = torch.exp(logits - lse)  # (B, H, Sq, Sk) fp32, transient
        dv = _low_precision_product("bhqk,bqhd->bkhd", p.to(v.dtype),
                                    dout.to(v.dtype), v.dtype)
        with _exact_tf32(dout.dtype, dout.device):
            dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
        delta = torch.einsum("bqhd,bqhd->bhq", dout.float(), out.float())
        ds = p * (dp - delta[..., None])  # fp32
        ds_low = ds.to(q.dtype)
        dq = _low_precision_product("bhqk,bkhd->bqhd", ds_low, k, q.dtype) * scale
        dk = _low_precision_product("bhqk,bqhd->bkhd", ds_low, q, q.dtype) * scale
        dmask = None
        if mask is not None and mask.dtype != torch.bool and ctx.needs_input_grad[3]:
            dmask = ds.to(mask.dtype)
            if mask.dim() == 2:
                dmask = dmask.sum(dim=(1, 2))
            else:
                dims = tuple(i for i in range(ds.dim()) if mask.shape[i] == 1)
                dmask = dmask.sum(dim=dims, keepdim=True).reshape(mask.shape)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dmask, None,
                None, None)


def plain_attention(q, k, v, mask=None, kv_lens=None, scale=None,
                    is_causal=False):
    """``xla_attention_remat``: (B, Sq, H, D) -> (B, Sq, H, D) in v's dtype,
    differentiable with the recomputing backward."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RematAttention.apply(q, k, v, mask, kv_lens, scale, is_causal)


def dot_product_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    kv_lens: torch.Tensor | None = None,
    scale: float | None = None,
    backend: AttentionImplementation = "auto",
    attention_dtype: torch.dtype | None = _SENTINEL,  # type: ignore[assignment]
    is_causal: bool = False,
) -> torch.Tensor:
    """Unified attention entry point. fp32 q/k/v are cast to
    ``attention_dtype``; the output comes back in the input dtype."""
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("q, k, v must be (B, S, H, D)")
    if attention_dtype is _SENTINEL:
        attention_dtype = _DEFAULT_ATTENTION_DTYPE
    orig_dtype = q.dtype
    if q.dtype == torch.float32 and attention_dtype is not None:
        q, k, v = q.to(attention_dtype), k.to(attention_dtype), v.to(attention_dtype)

    if backend in ("eager", "sdpa"):
        backend = "xla"
    sp = _SEQ_PARALLEL
    if backend in ("auto", "ring") and sp is not None:
        mesh, axis, batch_axes = sp
        n = mesh[axis].size()
        eligible = _ring_eligible(q, k, mask, is_causal, n)
        if backend == "ring" and not eligible:
            raise ValueError(
                "backend='ring' needs self-attention (Sq == Sk, divisible by "
                f"the seq axis ({n})), no mask, non-causal; got "
                f"Sq={q.shape[1]} Sk={k.shape[1]} mask={mask is not None} "
                f"causal={is_causal}"
            )
        if eligible:
            from .ring_attention import ring_attention_sharded

            global _RING_DISPATCH_COUNT
            _RING_DISPATCH_COUNT += 1
            out = ring_attention_sharded(q, k, v, mesh, axis, kv_lens=kv_lens,
                                         scale=scale, batch_axes=batch_axes)
            return out.to(orig_dtype)
    elif backend == "ring":
        raise ValueError(
            "backend='ring' requires an active sequence_parallel(...) "
            "context (see ops.attention.sequence_parallel)"
        )
    if backend == "auto":
        flash_ok = (
            mask is None
            and q.shape[-1] % 64 == 0
            and q.shape[1] >= MIN_FLASH_SEQ
            and k.shape[1] >= MIN_FLASH_SEQ
            and _on_cuda(q)
        )
        backend = "flash" if flash_ok else "xla"
    if backend == "flash":
        if mask is not None:
            raise ValueError(
                "flash backend takes kv_lens (suffix padding), not a full mask"
            )
        out = flash_attention(q, k, v, kv_lens, scale=scale, causal=is_causal)
    elif backend == "short":
        if mask is not None or is_causal:
            raise ValueError("short backend takes kv_lens only (no mask/causal)")
        out = short_attention(q, k, v, kv_lens, scale)
    elif backend == "xla":
        out = plain_attention(q, k, v, mask, kv_lens, scale, is_causal)
    else:
        raise ValueError(f"Unknown backend: {backend}")
    return out.to(orig_dtype)
