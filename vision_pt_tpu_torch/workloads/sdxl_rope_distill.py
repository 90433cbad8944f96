"""SDXL RoPE-retrofit distillation (port of
``vision_pt_tpu/workloads/sdxl_rope_distill.py``).

The RoPE-retrofitted UNet (the student) learns against its own forward with
RoPE and the adapters off (the teacher, no gradient), on the same weights,
and optionally against both again on a bicubic-downscaled copy of the batch
for resolution generalization: teacher, student, low-res student, low-res
teacher. The student passes run at the flags' resting state (RoPE on,
adapters on), so per-layer recompute, which reads them again in the
backward, sees what the forward saw. The step's draws (both VAE samples'
noise, the timesteps, both latent noises) come from ``draw_randoms``, so a
test can hand in others.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..models.sdxl.adapter.rope import (
    DenoiserConfigWithRoPE,
    SDXLWithRoPEConfig,
    SDXLWithRoPEModel,
    while_rope_disabled,
    while_rope_enabled,
)
from ..ops.loss.diffusion import loss_with_predicted_noise, prepare_noised_latents
from ..peft.functional import while_peft_disabled
from .sdxl_text_to_image import (
    SDXLForTextToImageTraining,
    SDXLForTextToImageTrainingConfig,
    SDXLTrainable,
)


class SDXLForRoPEDistillTrainingConfig(SDXLForTextToImageTrainingConfig, SDXLWithRoPEConfig):
    denoiser: DenoiserConfigWithRoPE = DenoiserConfigWithRoPE()
    max_token_length: int = 225

    l2_loss_weight: float = 1.0
    distill_loss_weight: float = 1.0

    lowres_l2_loss_weight: float = 0.0
    lowres_distill_loss_weight: float = 1.0

    lowres_ratio: float = 2.0


def downscale(pixel_values, original_size, target_size, crop_coords, ratio: float):
    """NHWC pixels shrunk by ``ratio`` (the JAX package's
    ``jax.image.resize(..., "cubic")``: Keys' cubic, a = -0.5, antialiased)
    and the size conditioning rescaled."""
    _, h, w, _ = pixel_values.shape
    resized = F.interpolate(pixel_values.float().permute(0, 3, 1, 2),
                            size=(math.ceil(h / ratio), math.ceil(w / ratio)), mode="bicubic",
                            align_corners=False, antialias=True).permute(0, 2, 3, 1)
    return (resized.to(pixel_values.dtype), torch.ceil(original_size / ratio),
            torch.ceil(target_size / ratio), torch.floor(crop_coords / ratio))


class SDXLRoPEDistillTraining(SDXLForTextToImageTraining):
    mesh_draws = ("vae_noise", "timesteps", "noise", "lowres_vae_noise", "lowres_noise")
    model: SDXLWithRoPEModel
    model_config: SDXLForRoPEDistillTrainingConfig
    model_config_class = SDXLForRoPEDistillTrainingConfig
    pipeline_class = SDXLWithRoPEModel

    def setup_model(self):
        self.model_config.denoiser.rope_enabled = True  # the student's mode
        super().setup_model()

    def _lowres(self) -> bool:
        cfg = self.model_config
        return cfg.lowres_l2_loss_weight > 0 or cfg.lowres_distill_loss_weight > 0

    def draw_randoms(self, batch: dict, generator: torch.Generator) -> dict:
        """The base draws, then the low-res VAE sample's and latent noise."""
        draws = super().draw_randoms(batch, generator)
        if self._lowres():
            b, h, w, _ = batch["image"].shape
            ratio, scale = self.model_config.lowres_ratio, self.model.vae.compression_ratio
            shape = (b, math.ceil(h / ratio) // scale, math.ceil(w / ratio) // scale,
                     self.model.vae.latent_channels)
            for name in ("lowres_vae_noise", "lowres_noise"):
                draws[name] = torch.randn(shape, generator=generator, device=self.device)
        return draws

    def compute_loss(self, trainable, batch: dict, draws: dict):
        cfg = self.model_config
        images = batch["image"]
        denoiser = trainable.denoiser if isinstance(trainable, SDXLTrainable) else trainable
        vae = self.model.vae
        with torch.no_grad():
            ehs, pooled = self._encode_text(trainable, batch["ids1"], batch["ids2"],
                                            images.shape[0])
            latents = vae.encode(images).sample(noise=draws["vae_noise"]) * vae.scaling_factor
        timesteps = draws["timesteps"]
        noisy, noise = prepare_noised_latents(None, latents, timesteps, draw=draws["noise"])
        sizes = (batch["original_size"], batch["target_size"], batch["crop_coords_top_left"])

        def denoise(noisy_latents, osz, tsz, crop):
            return denoiser(noisy_latents, timesteps.float(), ehs, pooled, osz, tsz, crop)

        teacher_pred = None
        if cfg.distill_loss_weight > 0:
            with torch.no_grad(), while_peft_disabled(denoiser), while_rope_disabled(denoiser):
                teacher_pred = denoise(noisy, *sizes)
        with while_rope_enabled(denoiser):
            student_pred = denoise(noisy, *sizes)

        lowres_student = lowres_teacher = lowres_latents = lowres_noise = None
        if self._lowres():
            lr_pixels, *lr_sizes = downscale(images, *sizes, cfg.lowres_ratio)
            with torch.no_grad():
                lowres_latents = (vae.encode(lr_pixels).sample(noise=draws["lowres_vae_noise"])
                                  * vae.scaling_factor)
            lowres_noisy, lowres_noise = prepare_noised_latents(
                None, lowres_latents, timesteps, draw=draws["lowres_noise"])
            with while_rope_enabled(denoiser):
                lowres_student = denoise(lowres_noisy, *lr_sizes)
            if cfg.lowres_distill_loss_weight > 0:
                with (torch.no_grad(), while_peft_disabled(denoiser),
                      while_rope_disabled(denoiser)):
                    lowres_teacher = denoise(lowres_noisy, *lr_sizes)

        def mse(a, b):
            return torch.mean(torch.square(a.float() - b.float()))

        total = torch.zeros((), device=images.device)
        metrics: dict[str, torch.Tensor] = {}
        terms = (
            ("l2_loss", cfg.l2_loss_weight,
             lambda: loss_with_predicted_noise(latents, noise, student_pred)),
            ("distill_loss", cfg.distill_loss_weight, lambda: mse(student_pred, teacher_pred)),
            ("lowres_l2_loss", cfg.lowres_l2_loss_weight,
             lambda: loss_with_predicted_noise(lowres_latents, lowres_noise, lowres_student)),
            ("lowres_distill_loss", cfg.lowres_distill_loss_weight,
             lambda: mse(lowres_student, lowres_teacher)),
        )
        for name, weight, term in terms:
            if weight > 0:
                value = term()
                metrics[name] = value.detach()
                total = total + value * weight
        return total, metrics
