"""DDPM epsilon-prediction noising and loss (port of
``vision_pt_tpu/ops/loss/diffusion.py``: the diffusers DDPM ``add_noise``
with the SD scaled-linear beta schedule).

Noise comes from an explicit ``torch.Generator``, or ``draw=`` hands in the
standard-normal draw.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .flow_match import NoisedLatents, _expand_t, _noise


@lru_cache(maxsize=8)
def _alphas_cumprod(beta_start: float, beta_end: float,
                    num_train_timesteps: int) -> np.ndarray:
    """cumprod(1 - beta) of the sqrt-linspace-squared betas, fp32."""
    betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                        dtype=np.float32) ** 2
    return np.cumprod(1.0 - betas, axis=0, dtype=np.float32)


def prepare_noised_latents(generator, latents: torch.Tensor,
                           timestep: torch.Tensor,  # (B,) int, 0 <= t < T
                           max_sigma: float = 1.0, beta_start: float = 0.00085,
                           beta_end: float = 0.012, num_train_timesteps: int = 1000,
                           *, draw=None) -> NoisedLatents:
    """noisy = sqrt(acp[t]) * latents + sqrt(1 - acp[t]) * noise."""
    acp = torch.from_numpy(_alphas_cumprod(beta_start, beta_end,
                                           num_train_timesteps)).to(latents.device)
    a_t = acp[timestep.long()]
    sqrt_alpha = _expand_t(torch.sqrt(a_t), latents)
    sqrt_one_minus = _expand_t(torch.sqrt(1.0 - a_t), latents)
    noise = _noise(generator, latents, draw) * max_sigma
    return NoisedLatents(sqrt_alpha * latents + sqrt_one_minus * noise, noise)


def loss_with_predicted_noise(latents: torch.Tensor, random_noise: torch.Tensor,
                              predicted_noise: torch.Tensor) -> torch.Tensor:
    """The eps-MSE in fp32 (``latents`` is unused, as in the JAX package)."""
    return torch.mean(torch.square(predicted_noise.float() - random_noise.float()))
