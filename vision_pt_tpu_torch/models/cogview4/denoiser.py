"""CogView4 DiT (port of ``vision_pt_tpu/models/cogview4/denoiser.py``).

A joint text+image token stream with per-stream AdaLN-Zero conditioning (a
12-way time projection), rotate-half RoPE on the image tokens only, one
feed-forward shared by both streams, and an AdaLN final layer. Latents are
NHWC; patchify uses the shared (c, ph, pw) feature order. The joint
self-attention is ``dot_product_attention`` with no mask: on the card at
S >= 1024 (every resolution from 512^2 on) it is the flash kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import dot_product_attention
from ...ops.linear import Linear
from ...ops.norm import fp32_layer_norm
from ...ops.offload import OffloadableModuleMixin
from ...ops.patch import patchify, unpatchify
from ...ops.timestep.embedding import (
    TextTimestepEmbedding,
    TimestepEmbedding,
    get_timestep_embedding,
)
from .config import DenoiserConfig


def _linear(din, dout, kw):
    return Linear(din, dout, std=None, **kw)


class GlobalConditionEmbedding(nn.Module):
    """The timestep and the SDXL-style size conditions, through SiLU."""

    def __init__(self, embedding_dim: int, condition_dim: int,
                 pooled_projection_dim: int, timesteps_dim: int = 256, *,
                 dtype=None, param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.condition_dim = condition_dim
        self.timesteps_dim = timesteps_dim
        self.timestep_embedder = TimestepEmbedding(timesteps_dim, embedding_dim, **kw)
        self.condition_embedder = TextTimestepEmbedding(pooled_projection_dim,
                                                        embedding_dim, **kw)

    def forward(self, timestep, original_size, target_size, crop_coords,
                hidden_dtype):
        t_proj = get_timestep_embedding(timestep, self.timesteps_dim,
                                        flip_sin_to_cos=True, downscale_freq_shift=0)
        batch = original_size.shape[0]
        cond_proj = torch.cat([
            get_timestep_embedding(c.reshape(-1), self.condition_dim,
                                   flip_sin_to_cos=True,
                                   downscale_freq_shift=0).reshape(batch, -1)
            for c in (original_size, crop_coords, target_size)], dim=1)
        t_emb = self.timestep_embedder(t_proj.to(hidden_dtype))
        c_emb = self.condition_embedder(cond_proj.to(hidden_dtype))
        return F.silu(t_emb + c_emb)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels, hidden_dim, patch_size, text_hidden_dim, *,
                 dtype=None, param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.proj = _linear(in_channels * patch_size**2, hidden_dim, kw)
        self.text_proj = _linear(text_hidden_dim, hidden_dim, kw)

    def forward(self, patches, encoder_hidden_states):
        return self.proj(patches), self.text_proj(encoder_hidden_states)


class AdaLayerNormZero(nn.Module):
    """12-way AdaLN-Zero over both streams; the chunks alternate image and
    text: shift, c_shift, scale, c_scale, gate, c_gate, then the same six for
    the MLP."""

    def __init__(self, embedding_dim: int, dim: int, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        self.linear = _linear(embedding_dim, 12 * dim, dict(
            dtype=dtype, param_dtype=param_dtype, generator=generator))

    def forward(self, hidden_states, encoder_hidden_states, time_embed):
        norm_h = fp32_layer_norm(hidden_states, eps=1e-5)
        norm_c = fp32_layer_norm(encoder_hidden_states, eps=1e-5)
        (shift_msa, c_shift_msa, scale_msa, c_scale_msa, gate_msa, c_gate_msa,
         shift_mlp, c_shift_mlp, scale_mlp, c_scale_mlp, gate_mlp,
         c_gate_mlp) = self.linear(time_embed).chunk(12, dim=1)
        h = norm_h * (1 + scale_msa[:, None]) + shift_msa[:, None]
        c = norm_c * (1 + c_scale_msa[:, None]) + c_shift_msa[:, None]
        return (h.to(hidden_states.dtype), gate_msa, shift_mlp, scale_mlp,
                gate_mlp, c.to(encoder_hidden_states.dtype), c_gate_msa,
                c_shift_mlp, c_scale_mlp, c_gate_mlp)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE: (real, imag) are the two HALVES of the feature dim,
    not interleaved pairs. x is (B, S, H, D); cos/sin (S, D) fp32."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


class SelfAttention(nn.Module):
    """Joint text+image attention; q/k LayerNorm per head (fp32, no affine,
    eps 1e-5); RoPE on the image segment only."""

    def __init__(self, hidden_dim, num_heads, use_bias=True, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_dim // num_heads
        kw = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                  generator=generator)
        self.to_q = _linear(hidden_dim, hidden_dim, kw)
        self.to_k = _linear(hidden_dim, hidden_dim, kw)
        self.to_v = _linear(hidden_dim, hidden_dim, kw)
        self.to_out = _linear(hidden_dim, hidden_dim, kw)

    def forward(self, hidden_states, encoder_hidden_states, rope_cos, rope_sin):
        text_len = encoder_hidden_states.shape[1]
        joint = torch.cat([encoder_hidden_states, hidden_states], dim=1)
        b, s, _ = joint.shape
        shape = (b, s, self.num_heads, self.head_dim)
        q = fp32_layer_norm(self.to_q(joint).reshape(shape), eps=1e-5)
        k = fp32_layer_norm(self.to_k(joint).reshape(shape), eps=1e-5)
        v = self.to_v(joint).reshape(shape)
        q = torch.cat([q[:, :text_len],
                       apply_rotary_emb(q[:, text_len:], rope_cos, rope_sin)], dim=1)
        k = torch.cat([k[:, :text_len],
                       apply_rotary_emb(k[:, text_len:], rope_cos, rope_sin)], dim=1)
        attn = dot_product_attention(q, k, v)
        out = self.to_out(attn.to(joint.dtype).reshape(b, s, -1))
        return out[:, text_len:], out[:, :text_len]


class FeedForward(nn.Module):
    """An MLP with tanh-approximate GeLU (torch keys net.0.proj / net.2)."""

    def __init__(self, hidden_dim, mlp_scale: float = 4.0, use_bias=True, *,
                 dtype=None, param_dtype=torch.float32, generator=None):
        super().__init__()
        inner = int(hidden_dim * mlp_scale)
        kw = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                  generator=generator)
        self.proj = _linear(hidden_dim, inner, kw)
        self.out = _linear(inner, hidden_dim, kw)

    def forward(self, x):
        return self.out(F.gelu(self.proj(x), approximate="tanh"))


def _modulate(x, scale, shift):
    return (fp32_layer_norm(x, eps=1e-5) * (1 + scale[:, None])
            + shift[:, None]).to(x.dtype)


class TransformerBlock(nn.Module):
    def __init__(self, hidden_dim=2560, num_attention_heads=64,
                 time_embed_dim=512, *, dtype=None, param_dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.norm1 = AdaLayerNormZero(time_embed_dim, hidden_dim, **kw)
        self.attn1 = SelfAttention(hidden_dim, num_attention_heads, **kw)
        self.ff = FeedForward(hidden_dim, **kw)

    def forward(self, hidden_states, encoder_hidden_states, time_embed,
                rope_cos, rope_sin):
        (norm_h, gate_msa, shift_mlp, scale_mlp, gate_mlp, norm_c, c_gate_msa,
         c_shift_mlp, c_scale_mlp, c_gate_mlp) = self.norm1(
            hidden_states, encoder_hidden_states, time_embed)
        attn_h, attn_c = self.attn1(norm_h, norm_c, rope_cos, rope_sin)
        hidden_states = hidden_states + attn_h * gate_msa[:, None].to(attn_h.dtype)
        encoder_hidden_states = (encoder_hidden_states
                                 + attn_c * c_gate_msa[:, None].to(attn_c.dtype))
        norm_h2 = _modulate(hidden_states, scale_mlp, shift_mlp)
        norm_c2 = _modulate(encoder_hidden_states, c_scale_mlp, c_shift_mlp)
        hidden_states = hidden_states + self.ff(norm_h2) * gate_mlp[:, None].to(
            hidden_states.dtype)
        encoder_hidden_states = encoder_hidden_states + self.ff(
            norm_c2) * c_gate_mlp[:, None].to(encoder_hidden_states.dtype)
        return hidden_states, encoder_hidden_states


class RoPE:
    """2-axis rotate-half tables, host-side NumPy (constants per latent
    shape). Grid positions are ``arange(h) * rope_axes_dim[0] // h`` in
    integers."""

    def __init__(self, head_dim: int, patch_size: int,
                 rope_axes_dim: tuple[int, int], theta: float = 10000.0):
        self.patch_size = patch_size
        self.rope_axes_dim = tuple(rope_axes_dim)
        dim_h = dim_w = head_dim // 2
        self.h_inv_freq = 1.0 / (
            theta ** (np.arange(0, dim_h, 2, dtype=np.float32)[: dim_h // 2] / dim_h))
        self.w_inv_freq = 1.0 / (
            theta ** (np.arange(0, dim_w, 2, dtype=np.float32)[: dim_w // 2] / dim_w))

    def __call__(self, latent_h: int, latent_w: int) -> tuple[np.ndarray, np.ndarray]:
        h, w = latent_h // self.patch_size, latent_w // self.patch_size
        inner_h = (np.arange(h) * self.rope_axes_dim[0] // h).astype(np.float32)
        inner_w = (np.arange(w) * self.rope_axes_dim[1] // w).astype(np.float32)
        freqs_h = np.outer(inner_h, self.h_inv_freq)  # (h, d/4)
        freqs_w = np.outer(inner_w, self.w_inv_freq)
        fh = np.broadcast_to(freqs_h[:, None, :], (h, w, freqs_h.shape[-1]))
        fw = np.broadcast_to(freqs_w[None, :, :], (h, w, freqs_w.shape[-1]))
        freqs = np.concatenate([fh, fw], axis=-1)
        freqs = np.concatenate([freqs, freqs], axis=-1).reshape(h * w, -1)
        return np.cos(freqs), np.sin(freqs)


class FinalAdaLayerNorm(nn.Module):
    def __init__(self, hidden_dim: int, condition_dim: int, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        self.linear = _linear(condition_dim, 2 * hidden_dim, dict(
            dtype=dtype, param_dtype=param_dtype, generator=generator))

    def forward(self, hidden_states, condition):
        # a second SiLU over a condition already through one
        condition = F.silu(condition).to(hidden_states.dtype)
        scale, shift = self.linear(condition).chunk(2, dim=-1)
        return _modulate(hidden_states, scale, shift)


class CogView4DiT(nn.Module, OffloadableModuleMixin):
    """The DiT; with an offload strategy set, its blocks move by groups
    between the device and pinned host memory during the forward."""

    def __init__(self, config: DenoiserConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        self.config = cfg = config
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.inner_dim = cfg.num_attention_heads * cfg.attention_head_dim
        self.out_channels = cfg.out_channels
        self.patch_size = cfg.patch_size
        self.vae_compression_ratio = cfg.vae_compression_ratio
        self.pooled_projection_dim = 3 * 2 * cfg.condition_dim
        self.rope = RoPE(head_dim=cfg.attention_head_dim, patch_size=cfg.patch_size,
                         rope_axes_dim=tuple(cfg.rope_axes_dim))
        self._rope_tables: dict = {}
        self.patch_embed = PatchEmbed(cfg.in_channels, self.inner_dim,
                                      cfg.patch_size, cfg.text_embed_dim, **kw)
        # the sinusoid of the timestep is inner_dim wide
        self.time_condition_embed = GlobalConditionEmbedding(
            cfg.time_embed_dim, cfg.condition_dim, self.pooled_projection_dim,
            timesteps_dim=self.inner_dim, **kw)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(self.inner_dim, cfg.num_attention_heads,
                             cfg.time_embed_dim, **kw)
            for _ in range(cfg.num_layers))
        self.norm_out = FinalAdaLayerNorm(self.inner_dim, cfg.time_embed_dim, **kw)
        self.proj_out = _linear(self.inner_dim,
                                cfg.patch_size**2 * cfg.out_channels, kw)

    def rope_tables(self, height: int, width: int, device) -> tuple[torch.Tensor, ...]:
        """(cos, sin) for a latent of (height, width), kept on ``device``."""
        key = (height, width, str(device))
        if key not in self._rope_tables:
            self._rope_tables[key] = tuple(
                torch.from_numpy(t).to(device) for t in self.rope(height, width))
        return self._rope_tables[key]

    def forward(
        self,
        latent: torch.Tensor,  # (B, H, W, C) NHWC
        encoder_hidden_states: torch.Tensor,  # (B, text_len, text_embed_dim)
        timestep: torch.Tensor,  # (B,)
        original_size: torch.Tensor,  # (B, 2)
        target_size: torch.Tensor,
        crop_coords: torch.Tensor,
    ) -> torch.Tensor:
        _, height, width, _ = latent.shape
        patches = patchify(latent, self.patch_size).patches
        hidden_states, encoder_hidden_states = self.patch_embed(
            patches, encoder_hidden_states)
        rope_cos, rope_sin = self.rope_tables(height, width, latent.device)
        global_cond = self.time_condition_embed(
            timestep, original_size, target_size, crop_coords, hidden_states.dtype)
        blocks = list(self.transformer_blocks)
        for i, block in enumerate(blocks):
            self.maybe_offload_by_group(blocks, i)
            hidden_states, encoder_hidden_states = block(
                hidden_states, encoder_hidden_states, global_cond, rope_cos, rope_sin)
        hidden_states = self.proj_out(self.norm_out(hidden_states, global_cond))
        return unpatchify(hidden_states, height // self.patch_size,
                          width // self.patch_size, self.patch_size,
                          self.out_channels)


class Denoiser(CogView4DiT):
    pass
