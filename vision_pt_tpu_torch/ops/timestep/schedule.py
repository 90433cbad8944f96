"""Inference timestep schedules (port of
``vision_pt_tpu/ops/timestep/schedule.py``), computed on the host."""

from __future__ import annotations

import numpy as np

from .sampling import get_lin_function


def get_flux_schedule(num_steps: int, image_seq_len: int, base_shift: float = 0.5,
                      max_shift: float = 1.15, shift: bool = True) -> list[float]:
    """The 1 -> 0 schedule of ``num_steps + 1`` entries, shifted by the
    flux time shift at ``image_seq_len`` (in float64; t = 0 stays 0)."""
    timesteps = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)
    if shift:
        mu = get_lin_function(y1=base_shift, y2=max_shift)(image_seq_len)
        with np.errstate(divide="ignore"):
            shifted = np.exp(mu) / (np.exp(mu) + (1.0 / timesteps - 1.0))
        shifted[timesteps == 0.0] = 0.0
        timesteps = shifted
    return [float(t) for t in timesteps]


def get_linear_schedule(num_steps: int, start: float = 1.0,
                        end: float = 0.0) -> np.ndarray:
    """``num_steps`` float32 values from ``start`` to ``end``."""
    return np.linspace(start, end, num_steps, dtype=np.float32)
