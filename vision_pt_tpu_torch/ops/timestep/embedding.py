"""Sinusoidal timestep embedding, computed in fp32, and the MLP embedders
over it (port of ``vision_pt_tpu/ops/timestep/embedding.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..linear import Linear


def get_timestep_embedding(
    timesteps: torch.Tensor,  # (...,) possibly fractional
    embedding_dim: int,
    flip_sin_to_cos: bool = False,
    downscale_freq_shift: float = 1.0,
    scale: float = 1.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """DDPM sinusoidal embedding: (*timesteps.shape, embedding_dim) fp32,
    [sin | cos] (or [cos | sin] if flipped), zero-padded if the dim is odd."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[..., None] * torch.exp(exponent)
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[..., half_dim:], emb[..., :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "silu": F.silu,
    "swish": F.silu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": gelu_tanh,
    "relu": F.relu,
    "mish": F.mish,
    "tanh": torch.tanh,
}


def get_activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation: {name}") from None


class TimestepEmbedding(nn.Module):
    """Linear -> act -> Linear over the sinusoid."""

    def __init__(self, in_channels: int, time_embed_dim: int,
                 act_fn: str = "silu", use_bias: bool = True, *,
                 param_dtype: torch.dtype = torch.float32,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                  generator=generator, std=None)
        self.linear_1 = Linear(in_channels, time_embed_dim, **kw)
        self.act = get_activation(act_fn)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim, **kw)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(self.act(self.linear_1(sample)))


class TextTimestepEmbedding(TimestepEmbedding):
    """The pooled-condition MLP: the same Linear -> act -> Linear."""

    def __init__(self, in_dim: int, hidden_dim: int, act_fn: str = "silu",
                 use_bias: bool = True, **kw):
        super().__init__(in_dim, hidden_dim, act_fn, use_bias, **kw)
