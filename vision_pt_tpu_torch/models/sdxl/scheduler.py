"""EulerDiscrete scheduler (port of ``vision_pt_tpu/models/sdxl/scheduler.py``;
diffusers EulerDiscreteScheduler, leading spacing, steps_offset=1).

The sigma tables are host-side NumPy, identical to the JAX package's. The
ancestral step draws its noise from an explicit ``torch.Generator``, or
takes it injected (``noise``), so a test can feed both packages the same
draws.
"""

from __future__ import annotations

import numpy as np
import torch


class Scheduler:
    beta_start: float = 0.00085
    beta_end: float = 0.012
    num_train_timesteps: int = 1000
    steps_offset: int = 1

    def get_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Leading-spaced integer timesteps."""
        step_ratio = self.num_train_timesteps // num_inference_steps
        timesteps = (
            np.arange(self.num_train_timesteps, 0, -step_ratio)
            .round()
            .astype(np.float32)
            - 1
        )
        return timesteps + self.steps_offset

    def get_sigmas(self, timesteps: np.ndarray) -> np.ndarray:
        """sigma = sqrt((1 - acp) / acp), interpolated at the timesteps,
        0-terminated."""
        betas = (
            np.linspace(self.beta_start**0.5, self.beta_end**0.5,
                        self.num_train_timesteps, dtype=np.float32)
            ** 2
        )
        alphas_cumprod = np.cumprod(1.0 - betas, dtype=np.float32)
        sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)
        sigmas = np.interp(timesteps, np.arange(len(sigmas)), sigmas)
        return np.concatenate([sigmas, [0.0]]).astype(np.float32)

    def get_max_noise_sigma(self, sigmas: np.ndarray) -> float:
        return float(np.sqrt(np.max(sigmas) ** 2 + 1.0))

    def scale_model_input(self, sample: torch.Tensor, current_sigma) -> torch.Tensor:
        """1 / sqrt(sigma^2 + 1) input scaling (the factor in fp32, then in
        the sample's dtype)."""
        sigma = np.float32(current_sigma)
        factor = np.sqrt(np.square(sigma) + np.float32(1.0))
        return sample / torch.tensor(float(factor), dtype=sample.dtype,
                                     device=sample.device)

    def ancestral_step(
        self,
        latent: torch.Tensor,
        noise_pred: torch.Tensor,
        sigma,
        next_sigma,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Stochastic up/down split Euler-ancestral step. ``noise`` overrides
        the draw from ``generator``. The sigma arithmetic is fp32."""
        sigma, next_sigma = np.float32(sigma), np.float32(next_sigma)
        sigma_up = np.sqrt(next_sigma**2 * (sigma**2 - next_sigma**2) / sigma**2)
        sigma_down = np.sqrt(next_sigma**2 - sigma_up**2)
        dt = torch.tensor(float(sigma_down - sigma), dtype=latent.dtype,
                          device=latent.device)
        up = torch.tensor(float(sigma_up), dtype=latent.dtype, device=latent.device)
        if noise is None:
            noise = torch.randn(latent.shape, generator=generator,
                                device=latent.device, dtype=latent.dtype)
        return latent + noise_pred * dt + noise.to(latent.device, latent.dtype) * up

    def step(self, latent, noise_pred, sigma, next_sigma) -> torch.Tensor:
        """Plain Euler step."""
        dt = torch.tensor(float(np.float32(next_sigma - sigma)),
                          dtype=latent.dtype, device=latent.device)
        return latent + noise_pred * dt
