"""Rectified-flow (flow-matching) noising and losses (port of
``vision_pt_tpu/ops/loss/flow_match.py``).

Noise comes from an explicit ``torch.Generator``, or ``draw=`` hands in the
standard-normal draw (tests give both sides the JAX package's). Everything
broadcasts over trailing dims (NHWC images and latent tensors alike).
"""

from __future__ import annotations

from typing import Literal, NamedTuple

import torch

ModelPredictionType = Literal["noise", "velocity", "image"]  # eps, v, x0


class NoisedLatents(NamedTuple):
    noisy_latents: torch.Tensor
    random_noise: torch.Tensor


def _expand_t(timestep: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) broadcastable against ``like``, in its dtype."""
    return timestep.reshape(timestep.shape[0], *([1] * (like.dim() - 1))).to(
        like.dtype
    )


def _noise(generator, like, draw):
    if draw is not None:
        return draw.to(device=like.device, dtype=like.dtype)
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=like.dtype)


def prepare_noised_latents(generator, latents, timestep, max_sigma: float = 1.0,
                           *, draw=None) -> NoisedLatents:
    """noisy = (1 - t) * latents + t * noise."""
    t = _expand_t(timestep, latents)
    noise = _noise(generator, latents, draw) * max_sigma
    return NoisedLatents((1.0 - t) * latents + t * noise, noise)


def prepare_scaled_noised_latents(generator, latents, timestep,
                                  noise_scale: float = 1.0,
                                  clean_at_zero: bool = False, *,
                                  draw=None) -> NoisedLatents:
    """Scaled noise with a polarity switch:

    clean_at_zero=True:  noisy = (1-t)*latents + t*noise   (t=0 is clean)
    clean_at_zero=False: noisy = t*latents + (1-t)*noise   (t=1 is clean; JiT)
    """
    t = _expand_t(timestep, latents)
    noise = _noise(generator, latents, draw) * noise_scale
    if clean_at_zero:
        noisy = (1.0 - t) * latents + t * noise
    else:
        noisy = t * latents + (1.0 - t) * noise
    return NoisedLatents(noisy, noise)


def get_flow_match_target_velocity(latents, random_noise):
    """v-target = noise - latents."""
    return random_noise - latents


def loss_with_predicted_velocity(latents, random_noise, predicted_velocity):
    """Mean-squared error against the v-target, in fp32."""
    target = (random_noise - latents).float()
    return torch.mean(torch.square(predicted_velocity.float() - target))


def convert_x0_to_velocity(x0, noisy_latents, timestep, eps: float = 1e-5,
                           clean_at_zero: bool = False):
    """x0-prediction -> velocity with an epsilon-clamped denominator."""
    t = _expand_t(timestep, x0)
    if clean_at_zero:
        return (noisy_latents - x0) / torch.clamp_min(t, eps)
    return (x0 - noisy_latents) / torch.clamp_min(1.0 - t, eps)
