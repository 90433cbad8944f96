"""Train-time timestep samplers (port of
``vision_pt_tpu/ops/timestep/sampling.py``).

Every sampler draws from an explicit ``torch.Generator``. Each one draws a
single base tensor (standard normal, uniform [0, 1) or integer indices) and
transforms it; ``draw=`` hands in that base tensor instead, so a test can
give the JAX package's draws to both sides. Continuous samplers return
float32 timesteps in [0, 1]; discrete (DDPM) samplers return int32 indices.
"""

from __future__ import annotations

import math
from typing import Callable, Literal, Sequence

import numpy as np
import torch

TimestepSamplingType = Literal[
    "shift_sigmoid",
    "flux_shift",
    "sigmoid",
    "uniform",
    "shift_uniform",
    "fraction_uniform",
    "shift_fraction_uniform",
    "scale_shift_sigmoid",
]


def _normal(generator, batch_size, device, draw):
    if draw is not None:
        return draw.to(device=device, dtype=torch.float32)
    return torch.randn(batch_size, generator=generator, device=device)


def _uniform(generator, batch_size, device, draw):
    if draw is not None:
        return draw.to(device=device, dtype=torch.float32)
    return torch.rand(batch_size, generator=generator, device=device)


def _randint(generator, batch_size, low, high, device, draw):
    if draw is not None:
        return draw.to(device=device, dtype=torch.int64)
    return torch.randint(low, high, (batch_size,), generator=generator,
                         device=device)


# MARK: flow-match


def get_lin_function(x1: float = 256.0, y1: float = 0.5, x2: float = 4096.0,
                     y2: float = 1.15) -> Callable[[float], float]:
    """Linear mu estimator for flux shift."""
    m = (y2 - y1) / (x2 - x1)
    b = y1 - m * x1
    return lambda x: m * x + b


def time_shift(mu: float, sigma: float, t: torch.Tensor) -> torch.Tensor:
    """Flux exponential time shift."""
    return math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0) ** sigma)


def time_shift_linear(mu: float, t):
    """CogView4's linear time shift, on a tensor or a numpy array."""
    return mu / (mu + (1.0 / t - 1.0))


def _shift(t: torch.Tensor, shift: float) -> torch.Tensor:
    return (t * shift) / (1.0 + (shift - 1.0) * t)


def sigmoid_randn(generator, batch_size: int, sigmoid_scale: float = 1.0, *,
                  device=None, draw=None) -> torch.Tensor:
    """t = sigmoid(N(0,1) * scale)."""
    return torch.sigmoid(_normal(generator, batch_size, device, draw) * sigmoid_scale)


def shift_sigmoid_randn(generator, batch_size: int,
                        discrete_flow_shift: float = 3.1825,
                        sigmoid_scale: float = 1.0, *, device=None,
                        draw=None) -> torch.Tensor:
    """Sigmoid sample followed by the discrete-flow shift."""
    t = sigmoid_randn(generator, batch_size, sigmoid_scale, device=device,
                      draw=draw)
    return _shift(t, discrete_flow_shift)


def flux_shift_randn(generator, batch_size: int, height: int, width: int,
                     sigmoid_scale: float = 1.0, *, device=None,
                     draw=None) -> torch.Tensor:
    """Resolution-dependent flux shift; mu from the token count
    (height // 2) * (width // 2)."""
    t = sigmoid_randn(generator, batch_size, sigmoid_scale, device=device,
                      draw=draw)
    mu = get_lin_function(y1=0.5, y2=1.15)((height // 2) * (width // 2))
    return time_shift(mu, 1.0, t)


def uniform_rand(generator, batch_size: int, *, device=None,
                 draw=None) -> torch.Tensor:
    """t ~ U[0, 1)."""
    return _uniform(generator, batch_size, device, draw)


def shift_uniform_rand(generator, batch_size: int, shift: float = 6.0, *,
                       device=None, draw=None) -> torch.Tensor:
    """Uniform then shift."""
    return _shift(uniform_rand(generator, batch_size, device=device, draw=draw),
                  shift)


def _create_fractions(denominators: Sequence[int]) -> np.ndarray:
    """The sorted unique i/d over all denominators d, 0 <= i <= d."""
    unique: set[float] = set()
    for d in denominators:
        for i in range(0, d + 1):
            unique.add(i / d)
    return np.array(sorted(unique), dtype=np.float32)


def fraction_uniform_rand(generator, batch_size: int,
                          divisible: Sequence[int] = tuple(range(20, 30)), *,
                          device=None, draw=None) -> torch.Tensor:
    """t drawn uniformly from the set of fractions i/d; ``draw`` is the
    index into that sorted set."""
    if len(divisible) == 0:
        raise ValueError("divisible must not be empty")
    fractions = torch.from_numpy(_create_fractions(divisible)).to(device)
    idx = _randint(generator, batch_size, 0, fractions.shape[0], device, draw)
    return fractions[idx]


def shift_fraction_uniform_rand(generator, batch_size: int, shift: float = 6.0,
                                divisible: Sequence[int] = tuple(range(20, 30)),
                                *, device=None, draw=None) -> torch.Tensor:
    """Fraction-uniform then shift."""
    t = fraction_uniform_rand(generator, batch_size, divisible, device=device,
                              draw=draw)
    return _shift(t, shift)


def scale_shift_sigmoid_randn(generator, batch_size: int, std: float = 0.8,
                              mean: float = -0.8, *, device=None,
                              draw=None) -> torch.Tensor:
    """JiT default: t = sigmoid(N(mean, std))."""
    return torch.sigmoid(_normal(generator, batch_size, device, draw) * std + mean)


def sample_timestep(generator, batch_size: int,
                    sampling_type: TimestepSamplingType = "sigmoid", *,
                    height: int | None = None, width: int | None = None,
                    device=None, draw=None, **kwargs) -> torch.Tensor:
    """Dispatch on ``sampling_type``, as the JAX package does."""
    common = dict(device=device, draw=draw)
    if sampling_type == "shift_sigmoid":
        return shift_sigmoid_randn(generator, batch_size, **kwargs, **common)
    if sampling_type == "flux_shift":
        if height is None or width is None:
            raise ValueError("flux_shift needs height and width")
        return flux_shift_randn(generator, batch_size, height, width, **kwargs,
                                **common)
    if sampling_type == "sigmoid":
        return sigmoid_randn(generator, batch_size, **kwargs, **common)
    if sampling_type == "uniform":
        return uniform_rand(generator, batch_size, **common)
    if sampling_type == "shift_uniform":
        return shift_uniform_rand(generator, batch_size, **kwargs, **common)
    if sampling_type == "fraction_uniform":
        return fraction_uniform_rand(generator, batch_size, **kwargs, **common)
    if sampling_type == "shift_fraction_uniform":
        return shift_fraction_uniform_rand(generator, batch_size, **kwargs,
                                           **common)
    if sampling_type == "scale_shift_sigmoid":
        return scale_shift_sigmoid_randn(generator, batch_size, **kwargs,
                                         **common)
    raise ValueError(f"Invalid sampling type: {sampling_type}")


# MARK: discrete (DDPM)


def uniform_randint(generator, batch_size: int, min_timesteps: int = 0,
                    max_timesteps: int = 1000, *, device=None,
                    draw=None) -> torch.Tensor:
    """t ~ U{min, ..., max - 1}."""
    return _randint(generator, batch_size, min_timesteps, max_timesteps,
                    device, draw).to(torch.int32)


def gaussian_randint(generator, batch_size: int, min_timesteps: int = 0,
                     max_timesteps: int = 1000, mean: float = 500.0,
                     std: float = 500.0, *, device=None,
                     draw=None) -> torch.Tensor:
    """Gaussian-weighted categorical over the integers [min, max];
    ``draw`` is the category index."""
    if draw is None:
        idx = torch.arange(min_timesteps, max_timesteps + 1, dtype=torch.float32,
                           device=device)
        weights = torch.softmax(-0.5 * torch.square((idx - mean) / std), dim=0)
        draw = torch.multinomial(weights, batch_size, replacement=True,
                                 generator=generator)
    return (draw.to(device) + min_timesteps).to(torch.int32)


def sigmoid_randint(generator, batch_size: int, min_timesteps: int = 0,
                    max_timesteps: int = 1000, sigmoid_scale: float = 1.0, *,
                    device=None, draw=None) -> torch.Tensor:
    """Sigmoid-of-normal scaled to the integer range, rounded half to even."""
    t = sigmoid_randn(generator, batch_size, sigmoid_scale, device=device,
                      draw=draw)
    t = t * (max_timesteps - min_timesteps) + min_timesteps
    return torch.round(t).to(torch.int32)
