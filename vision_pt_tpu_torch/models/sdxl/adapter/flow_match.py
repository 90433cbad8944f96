"""SDXL rectified-flow conversion (port of
``vision_pt_tpu/models/sdxl/adapter/flow_match.py``).

The SDXL UNet retargeted to flow matching: timesteps run 1000 -> 1 with
sigma = t / 1000, and the sampler takes plain Euler steps on the velocity.
An x0 prediction converts through :func:`convert_x0_to_velocity`.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from ....ops.loss.flow_match import ModelPredictionType, convert_x0_to_velocity
from ....utils import PromptType
from ..config import SDXLConfig
from ..pipeline import SDXLModel


class SDXLFlowMatchConfig(SDXLConfig):
    model_prediction: ModelPredictionType = "velocity"
    noise_scale: float = 1.0
    clean_at_zero: bool = False
    timestep_eps: float = 1e-5


class SDXLFlowMatch(SDXLModel):
    """``SDXLModel`` with the flow-match timesteps and Euler sampler."""

    config: SDXLFlowMatchConfig

    def prepare_timesteps(self, num_inference_steps: int):
        """1000 -> 1 timesteps in fp32; sigma = t / 1000 with a 0
        terminator."""
        timesteps = np.linspace(1000.0, 1.0, num_inference_steps, dtype=np.float32)
        sigmas = np.concatenate([timesteps / 1000.0, [0.0]]).astype(np.float32)
        return timesteps, sigmas

    @torch.inference_mode()
    def generate(
        self,
        prompt: PromptType,
        negative_prompt: PromptType | None = None,
        width: int = 768,
        height: int = 768,
        original_size: tuple[int, int] | None = None,
        target_size: tuple[int, int] | None = None,
        crop_coords_top_left: tuple[int, int] = (0, 0),
        num_inference_steps: int = 20,
        cfg_scale: float = 3.5,
        max_token_length: int = 75,
        seed: int | None = None,
        execution_dtype: torch.dtype = torch.bfloat16,
        latents: torch.Tensor | np.ndarray | None = None,  # NHWC, before noise_scale
        return_latents: bool = False,
    ) -> list[Image.Image] | torch.Tensor:
        """Euler on the velocity with CFG as ``v_neg + s (v_pos - v_neg)``.
        ``latents`` replaces the seeded standard-normal draw; the loop starts
        from it times ``noise_scale``. The guidance scale and the step are
        Python floats, so bf16 latents stay bf16, as in the JAX package."""
        cfg = self.config
        do_cfg = cfg_scale > 1.0
        timesteps, sigmas = self.prepare_timesteps(num_inference_steps)
        batch_size = len(prompt) if isinstance(prompt, list) else 1
        original_size = original_size or (height, width)
        target_size = target_size or (height, width)

        encoder_output = self.text_encoder.encode_prompts(
            prompt, negative_prompt, use_negative_prompts=do_cfg,
            max_token_length=max_token_length)
        latents = self.prepare_latents(
            batch_size, height, width, execution_dtype, max_noise_sigma=1.0,
            seed=seed, latents=latents) * cfg.noise_scale
        ehs, pooled = self.prepare_encoder_hidden_states(encoder_output, do_cfg)
        ehs, pooled = ehs.to(execution_dtype), pooled.to(execution_dtype)
        n = ehs.shape[0]

        def rows(pair):
            return torch.tensor(pair, dtype=torch.float32,
                                device=self.device).expand(n, 2)

        osz, tsz, crop = rows(original_size), rows(target_size), rows(crop_coords_top_left)
        for i, t in enumerate(timesteps):
            latent_in = torch.cat([latents] * 2) if do_cfg else latents
            t_batch = torch.full((latent_in.shape[0],), float(t), dtype=torch.float32,
                                 device=self.device)
            model_pred = self.denoiser(latent_in, t_batch, ehs, pooled, osz, tsz, crop)
            if cfg.model_prediction == "image":
                velocity = convert_x0_to_velocity(
                    model_pred, latent_in, t_batch / 1000.0, eps=cfg.timestep_eps,
                    clean_at_zero=cfg.clean_at_zero)
            elif cfg.model_prediction == "velocity":
                velocity = model_pred
            else:
                raise ValueError(f"Unknown model_prediction: {cfg.model_prediction}")
            if do_cfg:
                v_pos, v_neg = velocity.chunk(2)
                velocity = v_neg + cfg_scale * (v_pos - v_neg)
            dt = float(sigmas[i + 1] - sigmas[i])
            latents = latents + velocity.to(latents.dtype) * dt
        if return_latents:
            return latents
        return self.decode_image(latents)
