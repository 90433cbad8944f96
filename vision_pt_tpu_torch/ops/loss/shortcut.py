"""Shortcut Models self-consistency loss, arXiv 2410.12557 (port of
``vision_pt_tpu/ops/loss/shortcut.py``).

Every draw comes from an explicit ``torch.Generator``, or is handed in
(``exponent``, ``raw``) so a test can give both packages the same draws.
The teacher's two half steps run under ``torch.no_grad()`` and come back
detached, as the JAX package's ``stop_gradient`` leaves them. The denoiser
is any callable ``denoiser(latents, encoder_hidden_states, timestep,
shortcut_duration) -> velocity``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class ShortcutDuration(NamedTuple):
    inference_steps: torch.Tensor  # (B,) int32, power-of-two step counts
    shortcut_exponent: torch.Tensor  # (B,) int64, the exponent (dt_base)
    shortcut_duration: torch.Tensor  # (B,) float32, dt = 1 / steps
    departure_timesteps: torch.Tensor  # (B,) float32, the start t (1 -> 0)


def sample_weighted_inference_step_exponent(
    generator: torch.Generator | None, batch_size: int, min_pow: int = 0,
    max_pow: int = 7, *, device=None, draw: torch.Tensor | None = None,
) -> torch.Tensor:
    """Exponents in [min_pow, max_pow) drawn with weights sqrt(e) (e = 0
    gets 1e-10); ``draw`` hands in the exponents."""
    if draw is not None:
        return draw.to(device=device, dtype=torch.int64)
    exponents = torch.arange(min_pow, max_pow, device=device)
    weights = torch.sqrt(torch.clamp_min(exponents.to(torch.float64), 1e-20))
    idx = torch.multinomial(weights, batch_size, replacement=True, generator=generator)
    return exponents[idx]


def prepare_random_shortcut_durations(
    generator: torch.Generator | None, batch_size: int, min_pow: int = 0,
    max_pow: int = 7, *, device=None, exponent: torch.Tensor | None = None,
    raw: torch.Tensor | None = None,
) -> ShortcutDuration:
    """Random (steps, dt, departure t) triples. The departure is a / steps
    for a ~ U{1..steps}, with static shapes: raw ~ U{0..2^max_pow - 1} (or
    handed in), a = raw mod steps + 1."""
    exponent = sample_weighted_inference_step_exponent(
        generator, batch_size, min_pow, max_pow, device=device, draw=exponent)
    steps = (2 ** exponent).to(torch.int32)
    duration = 1.0 / steps.to(torch.float32)
    if raw is None:
        raw = torch.randint(0, 2 ** (max_pow - 1) * 2, (batch_size,),
                            generator=generator, device=device)
    a = raw.to(device=exponent.device, dtype=torch.int32) % steps + 1
    departure = a.to(torch.float32) / steps.to(torch.float32)
    return ShortcutDuration(steps, exponent, duration, departure)


class ShortcutTargets(NamedTuple):
    first_shortcut: torch.Tensor
    second_shortcut: torch.Tensor


DenoiserFn = Callable[..., torch.Tensor]


@torch.no_grad()
def prepare_self_consistency_targets(
    denoiser: DenoiserFn, latents: torch.Tensor,
    encoder_hidden_states: torch.Tensor, departure_timesteps: torch.Tensor,
    double_shortcut_duration: torch.Tensor, cfg_scale: float = 1.0,
) -> ShortcutTargets:
    """The teacher's two half steps of the double shortcut, detached."""
    half = double_shortcut_duration / 2.0
    first = denoiser(latents, encoder_hidden_states, departure_timesteps, half) * cfg_scale
    expand = (latents.shape[0],) + (1,) * (latents.dim() - 1)
    pseudo_midpoint = latents - first * half.reshape(expand).to(latents.dtype)
    second = denoiser(pseudo_midpoint, encoder_hidden_states,
                      departure_timesteps - half, half) * cfg_scale
    return ShortcutTargets(first.detach(), second.detach())


def get_shortcut_target_velocity(first_shortcut: torch.Tensor,
                                 second_shortcut: torch.Tensor) -> torch.Tensor:
    """The mean of the two half shortcuts."""
    return (first_shortcut + second_shortcut) / 2.0


def loss_with_shortcut_self_consistency(first_shortcut: torch.Tensor,
                                        second_shortcut: torch.Tensor,
                                        double_shortcut: torch.Tensor) -> torch.Tensor:
    """MSE in fp32 between the double shortcut and the halves' mean, the
    target detached."""
    target = ((first_shortcut + second_shortcut) / 2.0).detach().float()
    return torch.mean(torch.square(double_shortcut.float() - target))
