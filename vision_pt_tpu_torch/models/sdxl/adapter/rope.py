"""RoPE retrofit of the SDXL UNet (port of
``vision_pt_tpu/models/sdxl/adapter/rope.py``).

2D rotary embeddings in the UNet's self- and cross-attention, for
resolution generalization, with switches to turn them off for distillation
against the same weights without them. The tables are the JAX package's
host-side NumPy, cached per (height, width) / context length, and kept on
the device per (table, device), so the 70 blocks of a UNet share one copy.
The rotated q / k still go through ``dot_product_attention``: the
self-attention at S >= 1024 stays on the flash kernels.
"""

from __future__ import annotations

import functools
import math
from contextlib import contextmanager
from typing import Literal

import numpy as np
import torch
from torch import nn

from ....ops.attention import dot_product_attention
from ....ops.rope import apply_rope
from ..config import DenoiserConfig, SDXLConfig
from ..denoiser import CrossAttention, Denoiser, SelfAttention, TransformerBlock
from ..pipeline import SDXLModel

ORIGIN_POSITION = Literal["top_left", "center"]


@functools.lru_cache(maxsize=256)
def _freq_table(positions_key: tuple, dims: tuple[int, ...], theta: float) -> np.ndarray:
    """(seq, sum(dims) // 2, 2) cos / sin from per-axis integer positions."""
    positions = np.asarray(positions_key, dtype=np.float64)  # (seq, n_axes)
    parts = []
    for i, dim in enumerate(dims):
        omega = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        angles = np.outer(positions[:, i], omega)
        parts.append(np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32))
    return np.concatenate(parts, axis=-2)


_DEVICE_TABLES: dict[tuple, torch.Tensor] = {}


def _cached(key: tuple, make, device: torch.device) -> torch.Tensor:
    """The table ``make()`` builds, on ``device``, built once per key."""
    table = _DEVICE_TABLES.get((key, device))
    if table is None:
        table = _DEVICE_TABLES[(key, device)] = torch.as_tensor(make(), device=device)
    return table


class RoPEEmbedder:
    """The 2D image table and the diagonal context table."""

    def __init__(self, rope_dims=(32, 32), rope_theta: float = 10000.0,
                 origin_position: ORIGIN_POSITION = "top_left"):
        self.rope_dims = tuple(rope_dims)
        self.rope_theta = rope_theta
        self.origin_position = origin_position

    def _key(self, *shape) -> tuple:
        return (self.rope_dims, self.rope_theta, self.origin_position, *shape)

    def get_image_freqs(self, height: int, width: int) -> np.ndarray:
        ys = np.arange(height, dtype=np.int64)
        xs = np.arange(width, dtype=np.int64)
        if self.origin_position == "center":
            ys = ys - math.ceil(height // 2)
            xs = xs - math.ceil(width // 2)
        positions = tuple(map(tuple, np.stack([np.repeat(ys, width), np.tile(xs, height)],
                                              axis=1)))
        return _freq_table(positions, self.rope_dims, self.rope_theta)

    def get_context_freqs(self, length: int) -> np.ndarray:
        ids = np.arange(length, dtype=np.int64)
        positions = tuple(map(tuple, np.stack([ids, ids], axis=1)))
        return _freq_table(positions, self.rope_dims, self.rope_theta)

    def image_freqs(self, height: int, width: int, device) -> torch.Tensor:
        """``get_image_freqs`` as a tensor on ``device``, cached."""
        return _cached(self._key("image", height, width),
                       lambda: self.get_image_freqs(height, width), device)

    def context_freqs(self, length: int, device) -> torch.Tensor:
        return _cached(self._key("context", length),
                       lambda: self.get_context_freqs(length), device)


def _rotate(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """apply_rope over a (B, S, H, D) tensor: the table broadcast over heads."""
    return apply_rope(x, freqs[:, None])


class _WithRoPE:
    rope_enabled: bool = True

    def set_rope_enabled(self, enabled: bool):
        self.rope_enabled = enabled


class SelfAttentionWithRoPE(SelfAttention, _WithRoPE):
    def forward(self, hidden_states, mask=None, image_freqs=None):
        b, s, _ = hidden_states.shape
        shape = (b, s, self.num_heads, self.head_dim)
        q = self.to_q(hidden_states).reshape(shape)
        k = self.to_k(hidden_states).reshape(shape)
        v = self.to_v(hidden_states).reshape(shape)
        if self.rope_enabled and image_freqs is not None:
            q, k = _rotate(q, image_freqs), _rotate(k, image_freqs)
        attn = dot_product_attention(q, k, v, mask=mask)
        return self.to_out(attn.to(hidden_states.dtype).reshape(b, s, -1))


class CrossAttentionWithRoPE(CrossAttention, _WithRoPE):
    """q rotated by the image table, k by the diagonal context table."""

    def forward(self, query, context, mask=None, time_embedding=None, image_freqs=None,
                context_freqs=None, **kwargs):
        b, s, _ = query.shape
        sk = context.shape[1]
        q = self.to_q(query).reshape(b, s, self.num_heads, self.head_dim)
        k = self.to_k(context).reshape(b, sk, self.num_heads, self.head_dim)
        v = self.to_v(context).reshape(b, sk, self.num_heads, self.head_dim)
        if self.rope_enabled and image_freqs is not None:
            q, k = _rotate(q, image_freqs), _rotate(k, context_freqs)
        attn = dot_product_attention(q, k, v, mask=mask)
        return self.to_out(attn.to(query.dtype).reshape(b, s, -1))


class MigrationScale(nn.Module):
    """A learnable teacher -> RoPE blend."""

    def __init__(self, init_ratio: float = 0.0, log_scale: bool = False):
        super().__init__()
        self.log_scale = log_scale
        init = math.exp(init_ratio) if log_scale else init_ratio
        self.scale = nn.Parameter(torch.tensor(init, dtype=torch.float32))

    def get_scale(self) -> torch.Tensor:
        return torch.log(self.scale) if self.log_scale else self.scale


class TransformerWithRoPE(TransformerBlock, _WithRoPE):
    self_attention_class = SelfAttentionWithRoPE
    cross_attention_class = CrossAttentionWithRoPE

    rope_dims = (32, 32)
    rope_theta = 10000.0
    origin_position: ORIGIN_POSITION = "center"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rope_embedder = RoPEEmbedder(rope_dims=self.rope_dims,
                                          rope_theta=self.rope_theta,
                                          origin_position=self.origin_position)

    def forward(self, hidden_states, context, time_embedding=None,
                cross_attention_kwargs=None, height=None, width=None):
        image_freqs = context_freqs = None
        if self.rope_enabled:
            assert height is not None and width is not None
            device = hidden_states.device
            image_freqs = self.rope_embedder.image_freqs(height, width, device)
            context_freqs = self.rope_embedder.context_freqs(context.shape[1], device)
        hidden_states = hidden_states + self.attn1(self.norm1(hidden_states),
                                                   image_freqs=image_freqs)
        hidden_states = hidden_states + self.attn2(
            self.norm2(hidden_states), context, time_embedding=time_embedding,
            image_freqs=image_freqs, context_freqs=context_freqs,
            **(cross_attention_kwargs or {}))
        return hidden_states + self.ff(self.norm3(hidden_states))


class DenoiserConfigWithRoPE(DenoiserConfig):
    rope_enabled: bool = True
    migrating: bool = False
    rope_dims: list[int] = [32, 32]
    rope_theta: float = 10000.0
    origin_position: ORIGIN_POSITION = "center"


class DenoiserWithRoPE(Denoiser):
    transformer_block_class = TransformerWithRoPE

    def __init__(self, config: DenoiserConfigWithRoPE, **kw):
        super().__init__(config, **kw)
        self.apply_rope_config(config)
        self.set_rope_enabled(config.rope_enabled)

    def apply_rope_config(self, config: DenoiserConfigWithRoPE):
        for module in self.modules():
            if isinstance(module, TransformerWithRoPE):
                module.rope_embedder = RoPEEmbedder(rope_dims=tuple(config.rope_dims),
                                                    rope_theta=config.rope_theta,
                                                    origin_position=config.origin_position)

    def set_rope_enabled(self, enabled: bool):
        self.rope_enabled = enabled
        for module in self.modules():
            if isinstance(module, _WithRoPE):
                module.set_rope_enabled(enabled)


class SDXLWithRoPEConfig(SDXLConfig):
    denoiser: DenoiserConfigWithRoPE = DenoiserConfigWithRoPE()


class SDXLWithRoPEModel(SDXLModel):
    denoiser_class = DenoiserWithRoPE


def _resolve_denoiser(target) -> DenoiserWithRoPE:
    return target.denoiser if hasattr(target, "denoiser") else target


@contextmanager
def while_rope_enabled(model):
    """RoPE on for the duration; ``model`` is the pipeline, a tree holding
    ``denoiser``, or the denoiser itself. Per-layer recompute reads the flags
    again in the backward, after the context has exited: differentiate only
    passes run at the state the context restores."""
    denoiser = _resolve_denoiser(model)
    original = denoiser.rope_enabled
    denoiser.set_rope_enabled(True)
    try:
        yield
    finally:
        denoiser.set_rope_enabled(original)


@contextmanager
def while_rope_disabled(model):
    denoiser = _resolve_denoiser(model)
    original = denoiser.rope_enabled
    denoiser.set_rope_enabled(False)
    try:
        yield
    finally:
        denoiser.set_rope_enabled(original)
