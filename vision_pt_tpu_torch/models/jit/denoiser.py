"""JiT pixel-space rectified-flow Diffusion Transformer (port of
``vision_pt_tpu/models/jit/denoiser.py``).

Images are NHWC at the public functions, as in the JAX package. The token
sequence is [patches, imagesize(6), time(num_time_tokens), context], with the
context appended at ``context_start_block`` and stripped after each block
unless ``do_context_fuse``. RoPE runs rotate-half on a deinterleaved head dim,
so the JAX package's parameters map onto these modules by transposes alone
(``convert.from_jax_state``). Attention over the context-free blocks goes
through the packed short-attention CUDA kernels (forward and backward) on a
CUDA device. ``set_gradient_checkpointing`` recomputes each block in the
backward (``torch.utils.checkpoint``, the JAX package's ``nnx.remat``).
``positional_encoding: pope / n-pope`` selects the PoPE attention and
embedders of ``extension/pope.py``; the variants of ``extension/`` replace
the block stack through ``_build_blocks``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.attention import dot_product_attention, get_sequence_parallel
from ...ops.linear import Linear
from ...ops.norm import FP32RMSNorm, get_norm_layer
from ...ops.patch import patchify, pixel_shuffle_nhwc
from ...ops.short_attention import MAX_SHORT_SEQ, short_attention_packed
from ...ops.timestep.embedding import get_timestep_embedding
from .config import DenoiserConfig

# Gate of the packed kernel, kept at the JAX package's values. They were
# tuned on a TPU and are not yet measured on an H100.
MIN_PACKED_SEQ = 256


def _on_cuda(x: torch.Tensor) -> bool:
    """Where the packed kernel can run (the JAX gate's ``_on_tpu()``)."""
    return x.is_cuda


class BottleneckPatchEmbed(nn.Module):
    """Patch embedding via a bottleneck: two matmuls over flattened patches
    (``proj_1`` without bias, ``proj_2`` with)."""

    def __init__(self, patch_size=16, in_channels=3, bottleneck_dim=128,
                 hidden_dim=768, use_bias=True, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        self.patch_size = patch_size
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.proj_1 = Linear(in_channels * patch_size * patch_size,
                             bottleneck_dim, use_bias=False, **kw)
        self.proj_2 = Linear(bottleneck_dim, hidden_dim, use_bias=use_bias, **kw)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """NHWC image -> (B, num_patches, hidden)."""
        return self.proj_2(self.proj_1(patchify(image, self.patch_size).patches))


class TimestepEmbedder(nn.Module):
    """Sinusoid (flip_sin_to_cos=True, shift=0) + MLP."""

    def __init__(self, hidden_dim: int, freq_embedding_size: int = 256, *,
                 dtype=None, param_dtype=torch.float32, generator=None):
        super().__init__()
        self.freq_embedding_size = freq_embedding_size
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.linear_1 = Linear(freq_embedding_size, hidden_dim, **kw)
        self.linear_2 = Linear(hidden_dim, hidden_dim, **kw)

    def forward(self, timestep: torch.Tensor) -> torch.Tensor:
        freq = get_timestep_embedding(
            timestep, embedding_dim=self.freq_embedding_size,
            flip_sin_to_cos=True, downscale_freq_shift=0,
        ).to(self.linear_1.weight.dtype)
        return self.linear_2(F.silu(self.linear_1(freq)))


class RopeEmbedder:
    """Multi-axis rotary tables, host-side NumPy: angles are
    ``position * omega`` per axis, concatenated over axes."""

    def __init__(self, rope_theta: float = 256.0,
                 axes_dims: tuple[int, ...] = (32, 64, 64),
                 axes_lens: tuple[int, ...] = (256, 128, 128),
                 zero_centered: tuple[bool, ...] = (False, True, True)):
        self.rope_theta = rope_theta
        self.axes_dims = tuple(axes_dims)
        self.axes_lens = tuple(axes_lens)
        self.zero_centered = tuple(zero_centered)
        self.num_axes = len(axes_dims)

    def _omega(self, dim: int) -> np.ndarray:
        return 1.0 / (self.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))

    def __call__(self, position_ids: np.ndarray) -> np.ndarray:
        """(seq, n_axes) float positions -> (seq, head_dim//2, 2) cos/sin."""
        parts = []
        for i, dim in enumerate(self.axes_dims):
            angles = np.outer(position_ids[..., i].astype(np.float64), self._omega(dim))
            parts.append(
                np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)
            )
        return np.concatenate(parts, axis=-2)

    def prepare_image_position_ids(self, height: int, width: int,
                                   patch_size: int, global_index: int) -> np.ndarray:
        """Zero-centered (global, y, x) grid."""
        h_patches = height // patch_size
        w_patches = width // patch_size
        pos = np.zeros((h_patches, w_patches, self.num_axes), dtype=np.float32)
        pos[:, :, 0] = global_index
        pos[:, :, 1] = np.arange(h_patches // 2 - h_patches, h_patches // 2,
                                 dtype=np.float32)[:, None]
        pos[:, :, 2] = np.arange(w_patches // 2 - w_patches, w_patches // 2,
                                 dtype=np.float32)[None, :]
        return pos.reshape(-1, self.num_axes)

    def prepare_context_position_ids(self, seq_len: int,
                                     global_index: int = 0) -> np.ndarray:
        """(global, i, i) positions."""
        pos = np.zeros((seq_len, self.num_axes), dtype=np.float32)
        pos[:, 0] = global_index
        pos[:, 1] = np.arange(seq_len)
        pos[:, 2] = np.arange(seq_len)
        return pos


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in x's dtype; x (B, S, H, D) in the deinterleaved
    head-dim layout, freqs (S, D//2, 2)."""
    half = x.shape[-1] // 2
    cos = freqs[..., 0].to(x.dtype)
    sin = freqs[..., 1].to(x.dtype)
    cos_full = torch.cat([cos, cos], dim=-1)[None, :, None, :]
    sin_full = torch.cat([sin, sin], dim=-1)[None, :, None, :]
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos_full + rotated * sin_full


def _rms_rope(x: torch.Tensor, norm: FP32RMSNorm, rope_freqs: torch.Tensor):
    """RMS-normalized RoPE: ``rope((x/rms)·g) == rope(x·g)·(1/rms)``. The
    squares stay in x's dtype and accumulate in fp32, as the JAX package's
    matvec with a ``1/d`` vector in x's dtype does."""
    d = x.shape[-1]
    ones = torch.full((d,), 1.0 / d, dtype=x.dtype, device=x.device)
    ms = (x.square().float() * ones.float()).sum(dim=-1)
    inv = torch.rsqrt(ms + norm.eps)[..., None]
    if norm.weight is not None:
        x = x * norm.weight.to(x.dtype)
    return apply_rope(x, rope_freqs) * inv.to(x.dtype)


class Attention(nn.Module):
    """Self-attention with QKNorm + RoPE; q/k/v stay (B, S, H, D). The head
    count comes from the projections' width, so under tensor parallelism
    (``to_q``/``to_k``/``to_v`` split by columns) each rank attends over its
    own heads."""

    supports_tensor_parallel = True
    # QKNorm gains see only this rank's heads there: their gradients are
    # summed over the tensor ranks
    tensor_partial = ("q_norm", "k_norm")

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 qk_norm: bool = True, attn_dropout: float = 0.0,
                 proj_dropout: float = 0.0, eps: float = 1e-6,
                 norm_type: str = "rms", *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q_norm = self.k_norm = None
        if qk_norm:
            self.q_norm = get_norm_layer(norm_type, self.head_dim, eps=eps,
                                         param_dtype=param_dtype)
            self.k_norm = get_norm_layer(norm_type, self.head_dim, eps=eps,
                                         param_dtype=param_dtype)
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.to_q = Linear(dim, dim, use_bias=qkv_bias, **kw)
        self.to_k = Linear(dim, dim, use_bias=qkv_bias, **kw)
        self.to_v = Linear(dim, dim, use_bias=qkv_bias, **kw)
        self.to_o = Linear(dim, dim, **kw)

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return x.reshape(b, s, -1, self.head_dim)

    def qk_logit_bound(self) -> torch.Tensor | None:
        """Upper bound on |attention logit| under QKNorm:
        sqrt(D) * max|g_q| * max|g_k| (RMS-normalised rows have L2 norm
        sqrt(D); RoPE keeps norms). The packed kernel's no-max softmax is
        exact while it stays <= BOUNDED_LOGIT_CLIP (60). None without QKNorm
        or with gain-free norms."""
        q_w = getattr(self.q_norm, "weight", None)
        k_w = getattr(self.k_norm, "weight", None)
        if q_w is None or k_w is None:
            return None
        dim = torch.tensor(float(self.head_dim), device=q_w.device)
        return (torch.sqrt(dim) * q_w.detach().float().abs().max()
                * k_w.detach().float().abs().max())

    def _project_qkv(self, hidden_states, rope_freqs):
        q = self._split_heads(self.to_q(hidden_states))
        k = self._split_heads(self.to_k(hidden_states))
        v = self._split_heads(self.to_v(hidden_states))
        if (isinstance(self.q_norm, FP32RMSNorm)
                and isinstance(self.k_norm, FP32RMSNorm)
                and q.dtype != torch.float32):
            # fused RMSNorm+RoPE for low-precision q/k; fp32 takes the
            # plain path, as in the JAX package
            q = _rms_rope(q, self.q_norm, rope_freqs)
            k = _rms_rope(k, self.k_norm, rope_freqs)
        else:
            if self.q_norm is not None:
                q = self.q_norm(q)
                k = self.k_norm(k)
            q = apply_rope(q, rope_freqs)
            k = apply_rope(k, rope_freqs)
        return q, k, v

    def forward(self, hidden_states, rope_freqs, kv_lens=None, key_mask=None):
        b, s, _ = hidden_states.shape
        q, k, v = self._project_qkv(hidden_states, rope_freqs)
        if (key_mask is None and MIN_PACKED_SEQ <= s <= MAX_SHORT_SEQ
                and _on_cuda(hidden_states)
                # under sequence parallelism the ring owns the dispatch
                and get_sequence_parallel() is None):
            # packed (B, S, H*D) kernel over this rank's heads; QKNorm bounds
            # the logits, so the kernel may skip the softmax max subtraction
            attn = short_attention_packed(
                q.reshape(b, s, -1), k.reshape(b, s, -1), v.reshape(b, s, -1),
                q.shape[2], kv_lens, bounded=self.q_norm is not None,
            )
            return self.to_o(attn.to(hidden_states.dtype))
        if kv_lens is not None:
            attn = dot_product_attention(q, k, v, kv_lens=kv_lens)
        elif key_mask is not None:
            attn = dot_product_attention(q, k, v, mask=key_mask, backend="xla")
        else:
            attn = dot_product_attention(q, k, v)
        return self.to_o(attn.to(hidden_states.dtype).reshape(b, s, -1))


class SwiGLU(nn.Module):
    """SwiGLU MLP with the 2/3 width rule."""

    supports_tensor_parallel = True  # elementwise over the hidden features

    def __init__(self, dim: int, hidden_dim: int, use_bias: bool = True, *,
                 dtype=None, param_dtype=torch.float32, generator=None):
        super().__init__()
        hidden_dim = int(hidden_dim * 2 / 3)
        kw = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                  generator=generator)
        self.w_1 = Linear(dim, hidden_dim, **kw)
        self.w_2 = Linear(dim, hidden_dim, **kw)
        self.w_3 = Linear(hidden_dim, dim, **kw)

    def forward(self, x):
        return self.w_3(F.silu(self.w_1(x)) * self.w_2(x))


class FinalLayer(nn.Module):
    """norm -> SwiGLU -> linear projection to patches."""

    def __init__(self, hidden_dim, mlp_ratio, patch_size, out_channels,
                 eps=1e-6, norm_type="rms", *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.norm_final = get_norm_layer(norm_type, hidden_dim, eps=eps,
                                         param_dtype=param_dtype)
        self.mlp = SwiGLU(hidden_dim, int(hidden_dim * mlp_ratio), **kw)
        self.linear = Linear(hidden_dim, patch_size * patch_size * out_channels, **kw)

    def forward(self, x):
        return self.linear(self.mlp(self.norm_final(x)))


class BottleneckFinalLayer(nn.Module):
    """norm -> bottleneck -> projection."""

    def __init__(self, hidden_dim, bottleneck_dim, patch_size, out_channels,
                 norm_type="rms", *, dtype=None, param_dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.norm_final = get_norm_layer(norm_type, hidden_dim, eps=1e-6,
                                         param_dtype=param_dtype)
        self.proj_1 = Linear(hidden_dim, bottleneck_dim, use_bias=False, **kw)
        self.proj_2 = Linear(bottleneck_dim, patch_size * patch_size * out_channels, **kw)

    def forward(self, x):
        return self.proj_2(self.proj_1(self.norm_final(x)))


def attention_class_for(positional_encoding: str) -> type[Attention]:
    """RoPE attention, or PoPE's for ``pope`` / ``n-pope``."""
    if positional_encoding in ("pope", "n-pope"):
        from .extension.pope import PopeAttention

        return PopeAttention
    return Attention


class JiTBlock(nn.Module):
    """Pre-norm attention + SwiGLU block."""

    def __init__(self, hidden_dim, num_heads, mlp_ratio=4.0, qkv_bias=True,
                 qk_norm=True, use_bias=True, eps=1e-6,
                 positional_encoding="rope", norm_type="rms", attn_dropout=0.0,
                 proj_dropout=0.0, *, dtype=None, param_dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.norm1 = get_norm_layer(norm_type, hidden_dim, eps=eps,
                                    param_dtype=param_dtype)
        self.attn = attention_class_for(positional_encoding)(
            dim=hidden_dim, num_heads=num_heads, qkv_bias=qkv_bias,
            qk_norm=qk_norm, attn_dropout=attn_dropout,
            proj_dropout=proj_dropout, eps=eps, norm_type=norm_type, **kw,
        )
        self.norm2 = get_norm_layer(norm_type, hidden_dim, eps=eps,
                                    param_dtype=param_dtype)
        self.mlp = SwiGLU(hidden_dim, int(hidden_dim * mlp_ratio),
                          use_bias=use_bias, **kw)

    def forward(self, hidden_states, rope_freqs, kv_lens=None, key_mask=None):
        hidden_states = hidden_states + self.attn(
            self.norm1(hidden_states), rope_freqs, kv_lens=kv_lens,
            key_mask=key_mask,
        )
        return hidden_states + self.mlp(self.norm2(hidden_states))


class JiT(nn.Module):
    """The JiT denoiser. Parameters are created on the CPU from
    ``generator`` (normal(0.02) weights, zero biases, unit norm gains) and
    then moved to ``device``."""

    def __init__(self, config: DenoiserConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None,
                 device: str | torch.device = "cpu"):
        super().__init__()
        if config.hidden_size // config.num_heads != sum(config.rope_axes_dims):
            raise ValueError("sum(rope_axes_dims) must equal head_dim")
        self.config = config
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.patch_embedder = BottleneckPatchEmbed(
            patch_size=config.patch_size, in_channels=config.in_channels,
            bottleneck_dim=config.bottleneck_dim, hidden_dim=config.hidden_size,
            use_bias=True, **kw,
        )
        self.time_embedder = TimestepEmbedder(config.hidden_size, 256, **kw)
        self.time_position_embeds = nn.Parameter(
            torch.empty(config.num_time_tokens, config.hidden_size,
                        dtype=param_dtype)
        )
        with torch.no_grad():
            self.time_position_embeds.normal_(0.0, 0.02, generator=generator)
        self.image_size_embedder = TimestepEmbedder(config.hidden_size, 256, **kw)
        if config.positional_encoding == "rope":
            self.rope_embedder = RopeEmbedder(
                rope_theta=config.rope_theta,
                axes_dims=tuple(config.rope_axes_dims),
                axes_lens=tuple(config.rope_axes_lens),
                zero_centered=tuple(config.rope_zero_centered),
            )
        else:  # "pope" or "n-pope"
            from .extension.pope import NormalizedPopeEmbedder, PopeEmbedder

            embedder_class = (NormalizedPopeEmbedder
                              if config.positional_encoding == "n-pope"
                              else PopeEmbedder)
            self.rope_embedder = embedder_class(
                pope_theta=config.rope_theta,
                axes_dims=tuple(config.rope_axes_dims),
                axes_lens=tuple(config.rope_axes_lens),
                zero_centered=tuple(config.rope_zero_centered),
                do_normalize=tuple(config.rope_do_normalize),
                normalize_by=config.rope_normalize_by,
            )
        self.context_embedder = Linear(config.context_dim, config.hidden_size, **kw)
        self._build_blocks(config, **kw)
        if config.use_output_bottleneck:
            self.final_layer = BottleneckFinalLayer(
                config.hidden_size, config.bottleneck_dim, config.patch_size,
                config.out_channels, norm_type="rms", **kw,
            )
        else:
            self.final_layer = FinalLayer(
                config.hidden_size, config.mlp_ratio, config.patch_size,
                config.out_channels, eps=1e-6, norm_type="rms", **kw,
            )
        self._freqs_cache: dict[tuple, torch.Tensor] = {}
        self.gradient_checkpointing = False
        self.to(device)

    def _build_blocks(self, config: DenoiserConfig, **kw):
        """The block stack; the variants of ``extension/`` override it."""
        self.blocks = nn.ModuleList([
            JiTBlock(
                hidden_dim=config.hidden_size, num_heads=config.num_heads,
                mlp_ratio=config.mlp_ratio, attn_dropout=config.attn_dropout,
                proj_dropout=config.proj_dropout, qkv_bias=True, qk_norm=True,
                use_bias=True, eps=1e-6,
                positional_encoding=config.positional_encoding,
                norm_type=config.norm_type, **kw,
            )
            for _ in range(config.depth)
        ])

    def set_gradient_checkpointing(self, enable: bool = True):
        """Recompute each block's forward in the backward instead of keeping
        its activations."""
        self.gradient_checkpointing = enable

    def qk_logit_bound(self) -> torch.Tensor | None:
        """Max over every attention module of ``Attention.qk_logit_bound``:
        the observable of the bounded-softmax assumption, logged during
        training."""
        bounds = [b for b in (m.qk_logit_bound() for m in self.modules()
                              if isinstance(m, Attention))
                  if b is not None]
        return torch.stack(bounds).max() if bounds else None

    def _freqs_for(self, height: int, width: int, context_len: int,
                   device: torch.device) -> torch.Tensor:
        """Rotary (or PoPE) table for the full token sequence (patches,
        imagesize, time, context), each segment embedded on its own (the
        normalized PoPE rescales by a segment's own span), cached per
        embedder kind, shape and device."""
        key = (type(self.rope_embedder).__name__, height, width, context_len,
               device)
        if key not in self._freqs_cache:
            cfg, rope = self.config, self.rope_embedder
            table = np.concatenate([
                rope(rope.prepare_image_position_ids(height, width,
                                                     cfg.patch_size, 3)),
                rope(rope.prepare_context_position_ids(6, 2)),
                rope(rope.prepare_context_position_ids(cfg.num_time_tokens, 1)),
                rope(rope.prepare_context_position_ids(context_len, 0)),
            ], axis=0)
            self._freqs_cache[key] = torch.from_numpy(table).to(device)
        return self._freqs_cache[key]

    def get_imagesize_embed(self, original_size, target_size, crop_coords):
        """Six size-conditioning tokens."""
        size_info = torch.cat([original_size, target_size, crop_coords], dim=1)
        return self.image_size_embedder(size_info)

    def unpatchify(self, patches: torch.Tensor, height: int, width: int) -> torch.Tensor:
        """JiT's final-layer features are ordered (ph, pw, c), unlike
        ``ops.patch`` (c, ph, pw); the pixel-shuffle variant uses (c, ph, pw)."""
        cfg = self.config
        p = cfg.patch_size
        gh, gw = height // p, width // p
        batch = patches.shape[0]
        if cfg.use_pixel_shuffle:
            return pixel_shuffle_nhwc(patches.reshape(batch, gh, gw, -1), p)
        x = patches.reshape(batch, gh, gw, p, p, cfg.out_channels)
        x = x.permute(0, 1, 3, 2, 4, 5)  # (B, gh, P, gw, P, C)
        return x.reshape(batch, height, width, cfg.out_channels)

    def _prepare_inputs(self, image, timestep, context, original_size,
                        target_size, crop_coords, context_mask):
        cfg = self.config
        batch_size, height, width, _ = image.shape
        time_embed = self.time_embedder(timestep * cfg.timestep_scale)
        time_tokens = (
            time_embed[:, None, :] + self.time_position_embeds[None, :, :]
        ).to(time_embed.dtype)
        context_embed = self.context_embedder(context)
        imagesize_embed = self.get_imagesize_embed(
            original_size, target_size, crop_coords
        ).to(time_embed.dtype)
        patches = self.patch_embedder(image)
        patches_len = patches.shape[1]
        freqs = self._freqs_for(height, width, context_embed.shape[1], image.device)

        # tokens before the context are always valid; the context may be
        # right-padded
        prefix_len = patches_len + 6 + time_tokens.shape[1]
        kv_lens_full = key_mask_full = None
        if context_mask is not None:
            kv_lens_full = prefix_len + context_mask.to(torch.int32).sum(dim=1)
            key_mask_full = torch.cat([
                torch.ones(batch_size, prefix_len, dtype=torch.bool,
                           device=image.device),
                context_mask.to(torch.bool),
            ], dim=1)
        tokens = torch.cat([patches, imagesize_embed, time_tokens], dim=1)
        return (tokens, context_embed, freqs, kv_lens_full, key_mask_full,
                patches_len, prefix_len)

    def forward(self, image, timestep, context, original_size, target_size,
                crop_coords, context_mask=None):
        """image (B, H, W, C) NHWC, timestep (B,), context (B, L, context_dim),
        sizes (B, 2), context_mask (B, L) right-padded -> (B, H, W, C)."""
        patches, _ = self._trunk(image, timestep, context, original_size,
                                 target_size, crop_coords, context_mask)
        return self.unpatchify(self.final_layer(patches), image.shape[1],
                               image.shape[2])

    def _trunk(self, image, timestep, context, original_size, target_size,
               crop_coords, context_mask, taps: tuple[int, ...] = ()):
        """The block stack: the patch tokens after the last block, and
        {i: the patch tokens after block i (context stripped)} for each i of
        ``taps`` (IG's intermediate head reads one)."""
        cfg = self.config
        (tokens, context_embed, freqs, kv_lens_full, key_mask_full,
         patches_len, prefix_len) = self._prepare_inputs(
            image, timestep, context, original_size, target_size, crop_coords,
            context_mask,
        )
        context_len = context_embed.shape[1]
        tapped = {}
        for i, block in enumerate(self.blocks):
            if i == cfg.context_start_block or (
                not cfg.do_context_fuse and i >= cfg.context_start_block
            ):
                tokens = torch.cat([tokens, context_embed], dim=1)
            seq_len = tokens.shape[1]
            has_context = seq_len > prefix_len
            kv_lens = kv_lens_full if has_context else None
            key_mask = (
                key_mask_full[:, :seq_len]
                if has_context and key_mask_full is not None else None
            )
            tokens = self._run_block(block, tokens, freqs[:seq_len],
                                     kv_lens=kv_lens, key_mask=key_mask)
            if not cfg.do_context_fuse and i >= cfg.context_start_block:
                tokens = tokens[:, :-context_len, :]
            if i in taps:
                tapped[i] = tokens[:, :patches_len, :]
        return tokens[:, :patches_len, :], tapped

    def _run_block(self, block, *args, **kwargs):
        """One block, recomputed in the backward under gradient
        checkpointing."""
        if self.gradient_checkpointing and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False, **kwargs)
        return block(*args, **kwargs)


class Denoiser(JiT):
    """Alias used by checkpoints and pipelines."""
