"""SDXL IP-Adapter training (port of ``vision_pt_tpu/workloads/sdxl_ip_adapter.py``).

Self: the training image itself is the reference, resized (JAX's linear
resize, antialiased) to the vision tower's side and normalized by its mean
and std. Ref: the batch carries a separate ``reference_image``
(``ReferencedTextToImageDatasetConfig``). Kyara: Ref without image dropping.
Only the adapters' and the projector's AdapterParams train; the UNet, both
text towers, the VAE and the vision tower stay frozen. A batch's image-drop
draws come from ``np.random.default_rng(seed + 7)``, as in the JAX package;
the step's other draws from ``draw_randoms``, so a test can hand in others.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image
from torch import nn

from ..models.sdxl.adapter.ip_adapter import (
    SDXLModelWithIPAdapter,
    SDXLModelWithIPAdapterConfig,
)
from ..ops.loss.diffusion import loss_with_predicted_noise, prepare_noised_latents
from ..peft import freeze_all_but_adapters
from .sdxl_text_to_image import SDXLForTextToImageTraining, SDXLForTextToImageTrainingConfig


class SDXLModelWithIPAdapterTrainingConfig(SDXLForTextToImageTrainingConfig,
                                           SDXLModelWithIPAdapterConfig):
    max_token_length: int = 225
    drop_image_rate: float = 0.15
    token_tail_drop: bool = False
    token_tail_drop_rate: float = 0.5
    token_tail_drop_sampling: Literal["uniform"] = "uniform"


class IPAdapterTrainable(nn.Module):
    def __init__(self, denoiser, image_proj, text_encoder_1, text_encoder_2, vae):
        super().__init__()
        self.denoiser = denoiser  # holds the applied adapters
        self.image_proj = image_proj
        self.text_encoder = nn.ModuleDict(dict(text_encoder_1=text_encoder_1,
                                               text_encoder_2=text_encoder_2))
        self.vae = vae


def resize_images(images: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC -> NHWC at size x size: the JAX package's
    ``jax.image.resize(..., "linear")`` (a triangle filter widened by the
    scale when shrinking: bilinear with antialias)."""
    nchw = images.float().permute(0, 3, 1, 2)
    out = F.interpolate(nchw, size=(size, size), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def drop_image(rng: np.random.Generator, rate: float, batch_size: int,
               device: torch.device) -> torch.Tensor:
    """Which of the batch's images are dropped (their tokens zeroed): one
    host draw each, as the JAX package draws them."""
    return torch.as_tensor(rng.random(batch_size) < rate, device=device)


class SDXLIPAdapterSelfTraining(SDXLForTextToImageTraining):
    model: SDXLModelWithIPAdapter
    model_config: SDXLModelWithIPAdapterTrainingConfig
    model_config_class = SDXLModelWithIPAdapterTrainingConfig
    pipeline_class = SDXLModelWithIPAdapter
    drop_seed_offset = 7

    def setup_model(self):
        super().setup_model()  # with a checkpoint, the adapters come with it
        if not self.model.manager.module_dict:
            self.model.init_adapter()
        self._full_trainable = IPAdapterTrainable(
            self.model.denoiser, self.model.image_proj,
            self.model.text_encoder.text_encoder_1,
            self.model.text_encoder.text_encoder_2, self.model.vae)
        freeze_all_but_adapters(self._full_trainable)
        self._is_peft = True
        self._drop_rng = np.random.default_rng(self.config.seed + self.drop_seed_offset)

    def _reference_pixels(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC in [-1, 1] -> the vision tower's input."""
        cfg = self.model_config.adapter
        zero_one = (resize_images(images, cfg.image_size) + 1.0) / 2.0
        mean = torch.tensor(cfg.image_mean, device=images.device)
        std = torch.tensor(cfg.image_std, device=images.device)
        return (zero_one - mean) / std

    def prepare_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        arrays = super().prepare_batch(batch)
        ref = torch.as_tensor(np.asarray(batch.get("reference_image", batch["image"])))
        arrays["reference_pixels"] = self._reference_pixels(ref.to(self.device))
        arrays["drop_image"] = drop_image(self._drop_rng, self.model_config.drop_image_rate,
                                          arrays["image"].shape[0], self.device)
        return arrays

    def image_tokens(self, trainable, batch: dict) -> torch.Tensor:
        """The projector's tokens of the frozen tower's features, zero where
        the batch's draw dropped the image."""
        with torch.no_grad():
            features = self.model.encoder(batch["reference_pixels"])
        tokens = trainable.image_proj(features)
        return torch.where(batch["drop_image"][:, None, None], 0.0, tokens)

    def compute_loss(self, trainable: nn.Module, batch: dict, draws: dict):
        images = batch["image"]
        vae = self.model.vae
        with torch.no_grad():
            ehs, pooled = self._encode_text(trainable, batch["ids1"], batch["ids2"],
                                            images.shape[0])
            latents = (vae.encode(images).sample(noise=draws["vae_noise"])
                       * vae.scaling_factor)
        timesteps = draws["timesteps"]
        noisy, noise = prepare_noised_latents(None, latents, timesteps, draw=draws["noise"])
        ip_tokens = self.image_tokens(trainable, batch)
        noise_pred = trainable.denoiser(
            noisy, timesteps.float(), ehs, pooled, batch["original_size"],
            batch["target_size"], batch["crop_coords_top_left"],
            cross_attention_kwargs={"ip_tokens": ip_tokens})
        l2_loss = loss_with_predicted_noise(latents, noise, noise_pred)
        return l2_loss, {"l2_loss": l2_loss.detach()}

    def get_state_dict_to_save(self) -> dict[str, torch.Tensor]:
        return self.model.adapter_state_dict()

    def preview_step(self, preview_args, preview_index: int) -> list[Image.Image]:
        return self.model.generate(
            prompt=preview_args.prompt,
            negative_prompt=preview_args.negative_prompt or "",
            width=preview_args.width, height=preview_args.height,
            num_inference_steps=preview_args.num_steps,
            cfg_scale=preview_args.cfg_scale, seed=preview_args.seed,
            max_token_length=self.model_config.max_token_length)


class SDXLIPAdapterRefTraining(SDXLIPAdapterSelfTraining):
    """Reference-image variant: the batch carries ``reference_image``."""


class SDXLIPAdapterKyaraTraining(SDXLIPAdapterRefTraining):
    """Character-reference variant: no random image dropping."""

    def setup_model(self):
        super().setup_model()
        self.model_config.drop_image_rate = 0.0
