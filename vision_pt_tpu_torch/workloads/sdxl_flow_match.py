"""SDXL flow-match conversion fine-tuning (port of
``vision_pt_tpu/workloads/sdxl_flow_match.py``).

The text-to-image step with the rectified-flow objective: the VAE latents
of the batch's images are noised as ``t x + (1 - t) n`` (``clean_at_zero``
false) at t = ``sample_timestep`` (``scale_shift_sigmoid`` by default), the
UNet sees t * 1000 and its velocity (or x0) prediction is scored by
``_treat_fm_loss``. The previews go through ``SDXLFlowMatch.generate``. The
step's draws (the VAE sample's noise, the timesteps times 1000, the latent
noise) come from ``draw_randoms``, so a test can hand in others.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.sdxl.adapter.flow_match import SDXLFlowMatch, SDXLFlowMatchConfig
from ..ops.loss.flow_match import (
    ModelPredictionType,
    convert_x0_to_velocity,
    loss_with_predicted_velocity,
    prepare_scaled_noised_latents,
)
from ..ops.timestep.sampling import TimestepSamplingType, sample_timestep
from .sdxl_text_to_image import (
    SDXLForTextToImageTraining,
    SDXLForTextToImageTrainingConfig,
    SDXLTrainable,
)


class SDXLForFlowMatchingTrainingConfig(SDXLForTextToImageTrainingConfig,
                                        SDXLFlowMatchConfig):
    loss_type: ModelPredictionType = "velocity"
    timestep_sampling: TimestepSamplingType = "scale_shift_sigmoid"
    timestep_std: float = 0.8
    timestep_mean: float = -0.8


def _images(batch: dict) -> torch.Tensor:
    if "image" not in batch:
        raise ValueError("SDXL flow-match training encodes the batch's images "
                         "itself and takes no cached latents: use a dataset "
                         "with images (dataset.folder), not dataset.cache_dir")
    return batch["image"]


class SDXLForFlowMatchingTraining(SDXLForTextToImageTraining):
    model: SDXLFlowMatch
    model_config: SDXLForFlowMatchingTrainingConfig
    model_config_class = SDXLForFlowMatchingTrainingConfig
    pipeline_class = SDXLFlowMatch

    def draw_randoms(self, batch: dict, generator: torch.Generator) -> dict:
        """The VAE sample's noise, the timesteps (the sampler's t times
        1000, fp32) and the latent noise, standard normal."""
        cfg = self.model_config
        b, h, w, _ = _images(batch).shape
        ratio = self.model.vae.compression_ratio
        shape = (b, h // ratio, w // ratio, self.model.vae.latent_channels)
        kwargs = {}
        if cfg.timestep_sampling == "scale_shift_sigmoid":
            kwargs = {"std": cfg.timestep_std, "mean": cfg.timestep_mean}
        device = self.device
        vae_noise = torch.randn(shape, generator=generator, device=device)
        t = sample_timestep(generator, b, cfg.timestep_sampling, device=device,
                            **kwargs)
        noise = torch.randn(shape, generator=generator, device=device)
        return {"vae_noise": vae_noise, "timesteps": t * 1000.0, "noise": noise}

    def _treat_fm_loss(self, model_pred, latents, noise, noisy, timestep):
        cfg = self.model_config
        if cfg.model_prediction == "velocity":
            if cfg.loss_type == "velocity":
                return loss_with_predicted_velocity(latents, noise, model_pred)
            raise NotImplementedError(cfg.loss_type)
        if cfg.model_prediction == "image":
            if cfg.loss_type == "velocity":
                target_v = convert_x0_to_velocity(
                    latents, noisy, timestep, eps=cfg.timestep_eps,
                    clean_at_zero=cfg.clean_at_zero)
                v_pred = convert_x0_to_velocity(
                    model_pred, noisy, timestep, eps=cfg.timestep_eps,
                    clean_at_zero=cfg.clean_at_zero)
                return torch.mean(torch.square(v_pred.float() - target_v.float()))
            if cfg.loss_type == "image":
                return torch.mean(torch.square(model_pred.float()
                                               - latents.detach().float()))
            raise NotImplementedError(cfg.loss_type)
        raise ValueError(f"Unknown model_prediction: {cfg.model_prediction}")

    def compute_loss(self, trainable: nn.Module, batch: dict, draws: dict):
        cfg = self.model_config
        images = _images(batch)
        denoiser = trainable.denoiser if isinstance(trainable, SDXLTrainable) else trainable
        vae = self.model.vae
        with torch.no_grad():
            ehs, pooled = self._encode_text(trainable, batch["ids1"], batch["ids2"],
                                            images.shape[0])
            latents = (vae.encode(images).sample(noise=draws["vae_noise"])
                       * vae.scaling_factor)
        timesteps = draws["timesteps"]
        noisy, noise = prepare_scaled_noised_latents(
            None, latents, timesteps / 1000.0, noise_scale=cfg.noise_scale,
            clean_at_zero=cfg.clean_at_zero, draw=draws["noise"])
        model_pred = denoiser(noisy, timesteps, ehs, pooled, batch["original_size"],
                              batch["target_size"], batch["crop_coords_top_left"])
        loss = self._treat_fm_loss(model_pred, latents, noise, noisy,
                                   timesteps / 1000.0)
        return loss, {"l2_loss": loss.detach()}
