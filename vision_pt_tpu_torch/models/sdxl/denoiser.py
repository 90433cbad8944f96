"""SDXL UNet denoiser (port of ``vision_pt_tpu/models/sdxl/denoiser.py``).

Latents are NHWC at the public functions, as in the JAX package, so a
SpatialTransformer's token reshape is free. The modules carry the JAX
package's names (``input_blocks.blocks.N``, ``ff.geglu.proj``, ``in_norm``
...), and ``convert`` maps them to the reference's torch keys. The block
structure mirrors the reference's flattened input/middle/output lists,
including the quirk that each up stage's Upsample lives in the stage's last
layer list. Attention goes through ``ops.attention.dot_product_attention``:
``auto`` takes the flash kernel on the card for the unmasked self-attention
at S >= 1024 (every self-attention at 1024^2) and the plain path otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.attention import dot_product_attention
from ...ops.linear import Conv2d, Linear
from ...ops.norm import GroupNorm, LayerNorm
from ...ops.timestep.embedding import get_timestep_embedding
from .config import DenoiserConfig

# -------------------------------------------------------------- embedders


def _linear(din, dout, *, use_bias=True, dtype, param_dtype, generator):
    """``nnx.Linear`` with its default init variance (1/fan_in)."""
    return Linear(din, dout, use_bias=use_bias, dtype=dtype,
                  param_dtype=param_dtype, generator=generator, std=None)


def _conv(cin, cout, kernel, stride=1, padding=1, *, dtype, param_dtype, generator):
    return Conv2d(cin, cout, kernel, stride, padding, dtype=dtype,
                  param_dtype=param_dtype, generator=generator)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 of an NHWC tensor."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class MLPEmbedder(nn.Module):
    """Linear -> SiLU -> Linear (the reference's ``.0`` / ``.2``)."""

    def __init__(self, in_dim: int, hidden_dim: int, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.linear_1 = _linear(in_dim, hidden_dim, **kw)
        self.linear_2 = _linear(hidden_dim, hidden_dim, **kw)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


# -------------------------------------------------------------- attention


class SelfAttention(nn.Module):
    """q/k/v bias-free, out projection biased."""

    def __init__(self, num_heads: int, head_dim: int, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.to_q = _linear(inner, inner, use_bias=False, **kw)
        self.to_k = _linear(inner, inner, use_bias=False, **kw)
        self.to_v = _linear(inner, inner, use_bias=False, **kw)
        self.to_out = _linear(inner, inner, **kw)

    def forward(self, hidden_states, mask=None):
        b, s, _ = hidden_states.shape
        shape = (b, s, self.num_heads, self.head_dim)
        q = self.to_q(hidden_states).reshape(shape)
        k = self.to_k(hidden_states).reshape(shape)
        v = self.to_v(hidden_states).reshape(shape)
        attn = dot_product_attention(q, k, v, mask=mask)
        return self.to_out(attn.to(hidden_states.dtype).reshape(b, s, -1))


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, num_heads: int,
                 head_dim: int, *, dtype=None, param_dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.to_q = _linear(query_dim, inner, use_bias=False, **kw)
        self.to_k = _linear(context_dim, inner, use_bias=False, **kw)
        self.to_v = _linear(context_dim, inner, use_bias=False, **kw)
        self.to_out = _linear(inner, query_dim, **kw)

    def forward(self, query, context, mask=None, time_embedding=None, **kwargs):
        """``time_embedding`` and the ``cross_attention_kwargs`` (``kwargs``)
        reach every ``attn2``; an image adapter in its place reads them, the
        plain cross-attention ignores them."""
        b, s, _ = query.shape
        sk = context.shape[1]
        q = self.to_q(query).reshape(b, s, self.num_heads, self.head_dim)
        k = self.to_k(context).reshape(b, sk, self.num_heads, self.head_dim)
        v = self.to_v(context).reshape(b, sk, self.num_heads, self.head_dim)
        attn = dot_product_attention(q, k, v, mask=mask)
        return self.to_out(attn.to(query.dtype).reshape(b, s, -1))


class GeGLU(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        self.proj = _linear(in_dim, out_dim * 2, dtype=dtype,
                            param_dtype=param_dtype, generator=generator)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GeGLU -> Linear (the reference's ``net.0.proj`` / ``net.2``)."""

    def __init__(self, hidden_dim: int, multiplier: float = 4, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        inner = int(hidden_dim * multiplier)
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.geglu = GeGLU(hidden_dim, inner, **kw)
        self.out = _linear(inner, hidden_dim, **kw)

    def forward(self, x):
        return self.out(self.geglu(x))


class TransformerBlock(nn.Module):
    """self-attention -> cross-attention -> feed-forward, pre-LN. A subclass
    swaps the attentions through ``self_attention_class`` /
    ``cross_attention_class`` (the RoPE retrofit)."""

    self_attention_class = SelfAttention
    cross_attention_class = CrossAttention
    fsdp_unit = True  # gathered alone under FSDP (parallel.mesh)

    def __init__(self, hidden_dim: int, num_heads: int, head_dim: int,
                 context_dim: int = 2048, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.attn1 = self.self_attention_class(num_heads, head_dim, **kw)
        self.ff = FeedForward(hidden_dim, **kw)
        self.attn2 = self.cross_attention_class(hidden_dim, context_dim, num_heads,
                                                head_dim, **kw)
        norm = dict(dtype=dtype, param_dtype=param_dtype)
        self.norm1 = LayerNorm(hidden_dim, **norm)
        self.norm2 = LayerNorm(hidden_dim, **norm)
        self.norm3 = LayerNorm(hidden_dim, **norm)

    def forward(self, hidden_states, context, time_embedding=None,
                cross_attention_kwargs=None, height=None, width=None):
        """``height`` / ``width`` (the token grid's) are for a subclass; the
        plain block ignores them."""
        hidden_states = hidden_states + self.attn1(self.norm1(hidden_states))
        hidden_states = hidden_states + self.attn2(
            self.norm2(hidden_states), context, time_embedding=time_embedding,
            **(cross_attention_kwargs or {}))
        return hidden_states + self.ff(self.norm3(hidden_states))


class SpatialTransformer(nn.Module):
    """GroupNorm + linear projections around N transformer blocks."""

    def __init__(self, in_channels: int, num_heads: int, head_dim: int,
                 context_dims=(2048,), transformer_block_class=TransformerBlock, *,
                 dtype=None, param_dtype=torch.float32, generator=None):
        super().__init__()
        inner = num_heads * head_dim
        self.inner_dim = inner
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.norm = GroupNorm(in_channels, 32, eps=1e-6, dtype=dtype,
                              param_dtype=param_dtype)
        self.proj_in = _linear(in_channels, inner, **kw)
        self.transformer_blocks = nn.ModuleList([
            transformer_block_class(inner, num_heads, head_dim, context_dim=cd, **kw)
            for cd in context_dims
        ])
        self.proj_out = _linear(inner, in_channels, **kw)

    def forward(self, hidden_states, context, time_embedding=None,
                cross_attention_kwargs=None):
        b, h, w, c = hidden_states.shape
        residual = hidden_states
        x = self.proj_in(self.norm(hidden_states).reshape(b, h * w, c))
        for block in self.transformer_blocks:
            x = block(x, context, time_embedding, cross_attention_kwargs,
                      height=h, width=w)
        x = self.proj_out(x)
        return x.reshape(b, h, w, self.inner_dim) + residual


# -------------------------------------------------------------- resnet path


class Downsample(nn.Module):
    """Stride-2 conv, or 2x2 average pooling."""

    def __init__(self, hidden_dim: int, out_channels: int, use_resample: bool,
                 *, dtype=None, param_dtype=torch.float32, generator=None):
        super().__init__()
        self.op = (
            _conv(hidden_dim, out_channels, 3, stride=2, padding=1, dtype=dtype,
                  param_dtype=param_dtype, generator=generator)
            if use_resample else None
        )

    def forward(self, x):
        if self.op is not None:
            return self.op(x)
        return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class Upsample(nn.Module):
    """Nearest x2 + conv."""

    def __init__(self, hidden_dim: int, out_channels: int, use_resample: bool,
                 *, dtype=None, param_dtype=torch.float32, generator=None):
        super().__init__()
        self.conv = (
            _conv(hidden_dim, out_channels, 3, padding=1, dtype=dtype,
                  param_dtype=param_dtype, generator=generator)
            if use_resample else None
        )

    def forward(self, x):
        x = upsample_nearest(x)
        return self.conv(x) if self.conv is not None else x


class ResidualBlock(nn.Module):
    """GroupNorm/SiLU/conv x2 with the global condition added between."""

    fsdp_unit = True  # gathered alone under FSDP (parallel.mesh)

    def __init__(self, hidden_dim: int, embedding_dim: int, out_channels: int,
                 kernel_size: int = 3, num_norm_groups: int = 32, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        norm = dict(eps=1e-5, dtype=dtype, param_dtype=param_dtype)
        self.in_norm = GroupNorm(hidden_dim, num_norm_groups, **norm)
        self.in_conv = _conv(hidden_dim, out_channels, kernel_size,
                             padding=kernel_size // 2, **kw)
        self.emb_linear = _linear(embedding_dim, out_channels, **kw)
        self.out_norm = GroupNorm(out_channels, num_norm_groups, **norm)
        self.out_conv = _conv(out_channels, out_channels, kernel_size,
                              padding=kernel_size // 2, **kw)
        self.skip_connection = (
            _conv(hidden_dim, out_channels, 1, padding=0, **kw)
            if hidden_dim != out_channels else None
        )

    def forward(self, hidden_states, embedding):
        residual = hidden_states
        h = self.in_conv(F.silu(self.in_norm(hidden_states)))
        emb = self.emb_linear(F.silu(embedding))
        h = h + emb[:, None, None, :].to(h.dtype)
        h = self.out_conv(F.silu(self.out_norm(h)))
        if self.skip_connection is not None:
            residual = self.skip_connection(residual)
        return h + residual


# -------------------------------------------------------------- UNet blocks


class DownBlocksOutput(NamedTuple):
    hidden_states: torch.Tensor
    skip_connections: list[torch.Tensor]


def _apply_layer(layer, hidden_states, context, global_embedding,
                 time_embedding=None, cross_attention_kwargs=None):
    if isinstance(layer, ResidualBlock):
        return layer(hidden_states, global_embedding)
    if isinstance(layer, SpatialTransformer):
        return layer(hidden_states, context, time_embedding, cross_attention_kwargs)
    return layer(hidden_states)  # conv stem / Downsample / Upsample


def _apply_layer_remat(layer, hidden_states, context, global_embedding,
                       time_embedding=None, cross_attention_kwargs=None):
    """Per-layer recompute, the JAX package's ``nnx.remat`` of each layer:
    the backward runs the layer's forward again instead of keeping its
    activations (what fits 1024^2 training batches in memory). The
    recompute sees the same time embedding and cross-attention kwargs (an
    image adapter's tokens), and they take their gradients through it."""
    return checkpoint(_apply_layer, layer, hidden_states, context,
                      global_embedding, time_embedding, cross_attention_kwargs,
                      use_reentrant=False)


def _layer_fn(gradient_checkpointing: bool):
    return _apply_layer_remat if gradient_checkpointing else _apply_layer


def _spatial_transformer(channels, num_head_channels, num_transformers,
                         context_dim, block_class, kw):
    return SpatialTransformer(
        channels, num_heads=channels // num_head_channels,
        head_dim=num_head_channels,
        context_dims=[context_dim] * num_transformers,
        transformer_block_class=block_class, **kw,
    )


class DownBlocks(nn.Module):
    """The flattened input_blocks."""

    def __init__(self, in_channels, block_out_channels, down_blocks,
                 num_transformers_per_block, layers_per_block, time_embed_dim,
                 conv_resample, num_head_channels, context_dim,
                 transformer_block_class=TransformerBlock, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        blocks: list = []
        current = in_channels
        for i, (block, out_channels, num_transformers) in enumerate(
            zip(down_blocks, block_out_channels, num_transformers_per_block)
        ):
            if block == "DownBlock2D":
                blocks.append([_conv(in_channels, block_out_channels[0], 3,
                                     padding=1, **kw)])
                current = out_channels
                for _ in range(layers_per_block):
                    blocks.append([ResidualBlock(current, time_embed_dim,
                                                 out_channels, **kw)])
            elif block == "TransformerDownBlock2D":
                for _ in range(layers_per_block):
                    layers = [ResidualBlock(current, time_embed_dim, out_channels, **kw)]
                    current = out_channels
                    layers.append(_spatial_transformer(
                        out_channels, num_head_channels, num_transformers,
                        context_dim, transformer_block_class, kw))
                    blocks.append(layers)
            else:
                raise ValueError(f"Invalid block: {block}")
            if i != len(down_blocks) - 1:
                blocks.append([Downsample(out_channels, out_channels,
                                          use_resample=conv_resample, **kw)])
        self.blocks = nn.ModuleList(nn.ModuleList(layers) for layers in blocks)
        self.gradient_checkpointing = False

    def forward(self, hidden_states, context, global_embedding, time_embedding=None,
                cross_attention_kwargs=None) -> DownBlocksOutput:
        apply = _layer_fn(self.gradient_checkpointing)
        skips = []
        for layers in self.blocks:
            for layer in layers:
                hidden_states = apply(layer, hidden_states, context, global_embedding,
                                      time_embedding, cross_attention_kwargs)
            skips.append(hidden_states)
        return DownBlocksOutput(hidden_states, skips)


class MidBlock(nn.Module):
    """Res -> Transformer -> Res."""

    def __init__(self, hidden_dim, time_embed_dim, mid_block_type,
                 num_transformers, num_head_channels, context_dim,
                 transformer_block_class=TransformerBlock, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        blocks = [ResidualBlock(hidden_dim, time_embed_dim, hidden_dim, **kw)]
        if mid_block_type == "TransformerMidBlock2D":
            blocks.append(_spatial_transformer(hidden_dim, num_head_channels,
                                               num_transformers, context_dim,
                                               transformer_block_class, kw))
        blocks.append(ResidualBlock(hidden_dim, time_embed_dim, hidden_dim, **kw))
        self.blocks = nn.ModuleList(blocks)
        self.gradient_checkpointing = False

    def forward(self, hidden_states, context, global_embedding, time_embedding=None,
                cross_attention_kwargs=None):
        apply = _layer_fn(self.gradient_checkpointing)
        for layer in self.blocks:
            hidden_states = apply(layer, hidden_states, context, global_embedding,
                                  time_embedding, cross_attention_kwargs)
        return hidden_states


class UpBlocks(nn.Module):
    """The flattened output_blocks with concatenated skips; each non-final
    stage's Upsample is appended to that stage's LAST layer list (the
    reference's key layout)."""

    def __init__(self, in_channels, block_out_channels, down_skip_channels,
                 up_blocks, num_transformers_per_block, layers_per_block,
                 time_embed_dim, conv_resample, num_head_channels, context_dim,
                 transformer_block_class=TransformerBlock, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        down_skip_channels = list(down_skip_channels)
        blocks: list = []
        current = in_channels
        for i, (block, out_channels, num_transformers) in enumerate(
            zip(up_blocks, block_out_channels, num_transformers_per_block)
        ):
            if block not in ("UpBlock2D", "TransformerUpBlock2D"):
                raise ValueError(f"Invalid block: {block}")
            stage = []
            for _ in range(layers_per_block):
                layers = [ResidualBlock(current + down_skip_channels.pop(),
                                        time_embed_dim, out_channels, **kw)]
                current = out_channels
                if block == "TransformerUpBlock2D":
                    layers.append(_spatial_transformer(
                        out_channels, num_head_channels, num_transformers,
                        context_dim, transformer_block_class, kw))
                stage.append(layers)
            if i != len(up_blocks) - 1:
                stage[-1].append(Upsample(out_channels, out_channels,
                                          use_resample=conv_resample, **kw))
            blocks.extend(stage)
        self.blocks = nn.ModuleList(nn.ModuleList(layers) for layers in blocks)
        self.gradient_checkpointing = False

    def forward(self, hidden_states, context, global_embedding, skip_connections,
                time_embedding=None, cross_attention_kwargs=None):
        apply = _layer_fn(self.gradient_checkpointing)
        skips = list(skip_connections)
        for layers in self.blocks:
            hidden_states = torch.cat([hidden_states, skips.pop()], dim=-1)
            for layer in layers:
                hidden_states = apply(layer, hidden_states, context, global_embedding,
                                      time_embedding, cross_attention_kwargs)
        return hidden_states


# -------------------------------------------------------------- UNet


class UNet(nn.Module):
    """The SDXL UNet. Parameters are created on the current default device
    from ``generator`` (the ``nnx`` default init variances: 1/fan_in for
    linears and convs, zero biases, unit norm gains). A subclass swaps every
    transformer block through ``transformer_block_class``."""

    transformer_block_class = TransformerBlock

    def __init__(self, config: DenoiserConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        self.config = cfg = config
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        hidden_dim = cfg.hidden_dim
        time_embed_dim = hidden_dim * 4
        self.hidden_dim = hidden_dim
        self.additional_cond_dim = cfg.additional_condition_dim

        self.time_embed = MLPEmbedder(hidden_dim, time_embed_dim, **kw)
        self.label_emb = MLPEmbedder(cfg.global_cond_dim, time_embed_dim, **kw)
        self.input_blocks = DownBlocks(
            cfg.in_channels, cfg.block_out_channels, cfg.down_blocks,
            cfg.num_transformers_per_block, cfg.layers_per_block,
            time_embed_dim, cfg.conv_resample, cfg.num_head_channels,
            cfg.context_dim, self.transformer_block_class, **kw,
        )
        self.middle_block = MidBlock(
            cfg.block_out_channels[-1], time_embed_dim, cfg.mid_block,
            cfg.num_transformers_per_block[-1], cfg.num_head_channels,
            cfg.context_dim, self.transformer_block_class, **kw,
        )
        down_skip_channels = []
        for i, (block, channels) in enumerate(zip(cfg.down_blocks,
                                                  cfg.block_out_channels)):
            if block == "DownBlock2D":
                down_skip_channels.extend([channels] * (cfg.layers_per_block + 1))
            elif block == "TransformerDownBlock2D":
                down_skip_channels.extend([channels] * cfg.layers_per_block)
            if i != len(cfg.down_blocks) - 1:
                down_skip_channels.append(channels)
        self.output_blocks = UpBlocks(
            cfg.block_out_channels[-1], cfg.block_out_channels[::-1],
            down_skip_channels, cfg.up_blocks,
            cfg.num_transformers_per_block[::-1], cfg.layers_per_block + 1,
            time_embed_dim, cfg.conv_resample, cfg.num_head_channels,
            cfg.context_dim, self.transformer_block_class, **kw,
        )
        self.out_norm = GroupNorm(hidden_dim, 32, eps=1e-5, dtype=dtype,
                                  param_dtype=param_dtype)
        self.out_conv = _conv(hidden_dim, cfg.out_channels, 3, padding=1, **kw)

    def prepare_global_condition(self, timestep, text_pooler_output,
                                 original_size, target_size, crop_coords, dtype):
        """time MLP + (pooled, 6 x 256 size sincos) MLP."""
        time_embed = get_timestep_embedding(
            timestep, self.hidden_dim, flip_sin_to_cos=True,
            downscale_freq_shift=0.0)
        time_embed = self.time_embed(time_embed.to(dtype))
        batch = text_pooler_output.shape[0]
        additional = torch.cat([original_size, crop_coords, target_size], dim=1)
        additional = get_timestep_embedding(
            additional, self.additional_cond_dim, flip_sin_to_cos=True,
            downscale_freq_shift=0.0).reshape(batch, -1)
        global_cond = torch.cat(
            [text_pooler_output, additional.to(text_pooler_output.dtype)], dim=1
        ).to(dtype)
        return time_embed, self.label_emb(global_cond) + time_embed

    def forward(
        self,
        latents: torch.Tensor,  # (B, H, W, 4) NHWC
        timestep: torch.Tensor,  # (B,)
        encoder_hidden_states: torch.Tensor,  # (B, 77 * N, 2048)
        encoder_pooler_output: torch.Tensor,  # (B, 1280)
        original_size: torch.Tensor,  # (B, 2)
        target_size: torch.Tensor,  # (B, 2)
        crop_coords_top_left: torch.Tensor,  # (B, 2)
        cross_attention_kwargs: dict | None = None,
    ) -> torch.Tensor:
        """``cross_attention_kwargs`` (an image adapter's ``ip_tokens``,
        ``ip_mask``) and the time embedding reach every ``attn2``."""
        time_embed, global_cond = self.prepare_global_condition(
            timestep, encoder_pooler_output, original_size, target_size,
            crop_coords_top_left, latents.dtype)
        context, kw = encoder_hidden_states, cross_attention_kwargs
        h, skips = self.input_blocks(latents, context, global_cond, time_embed, kw)
        h = self.middle_block(h, context, global_cond, time_embed, kw)
        h = self.output_blocks(h, context, global_cond, skips, time_embed, kw)
        return self.out_conv(F.silu(self.out_norm(h)))

    def set_gradient_checkpointing(self, enable: bool):
        """Recompute each layer of the input, middle and output blocks in
        the backward."""
        for blocks in (self.input_blocks, self.middle_block, self.output_blocks):
            blocks.gradient_checkpointing = enable


class Denoiser(UNet):
    """Config-driven alias."""
