"""Sinusoidal timestep embedding (port of
``vision_pt_tpu/ops/timestep/embedding.py``), computed in fp32."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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
