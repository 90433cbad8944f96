"""JiT variant training workloads (port of the ARB workload of
``vision_pt_tpu/workloads/jit_variants.py``).

``JiTForArbClassToImageTraining`` takes the per-sample size conditioning from
the batch (aspect-ratio buckets, cached latents) and adds the optional
multi-resolution ``lowres_loss`` terms. The U-JiT, Cross, IG, LoIG and TREAD
variants are not ported yet (ROADMAP Queue 1, slice 3, item 6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.loss.flow_match import prepare_scaled_noised_latents
from .jit_class_to_image import JiTConfigForTraining, JiTForClassToImageTraining

_SIZE_FIELDS = ("original_size", "target_size", "crop_coords_top_left")


def _area_downsample(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Area downsampling of an NHWC batch by an integer factor 1/scale
    (``F.interpolate(mode='area')`` for integer factors)."""
    factor = int(round(1.0 / scale))
    pooled = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel_size=factor, stride=factor)
    return pooled.permute(0, 2, 3, 1)


class JiTConfigForArbTraining(JiTConfigForTraining):
    lowres_loss: list[float] = []  # e.g. [0.5, 0.25]


class JiTForArbClassToImageTraining(JiTForClassToImageTraining):
    """ARB variant: the batch provides per-sample size conditioning, and
    optional multi-resolution lowres losses are added."""

    model_config: JiTConfigForArbTraining
    model_config_class = JiTConfigForArbTraining

    def prepare_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        arrays = super().prepare_batch(batch)
        for name in _SIZE_FIELDS:
            if name in batch:
                arrays[name] = torch.as_tensor(batch[name]).float().to(self.device)
        return arrays

    def compute_loss(self, trainable, batch: dict, draws: dict):
        cfg = self.model_config
        images = batch["image"]
        batch_size = images.shape[0]
        context = trainable.class_encoder(batch["class_ids"])
        if not cfg.train_class_encoder:
            context = context.detach()
        timesteps = draws["timesteps"]
        noisy, noise = prepare_scaled_noised_latents(
            None, images, timesteps, noise_scale=cfg.noise_scale,
            draw=draws["noise"],
        )
        default_size = torch.tensor([[images.shape[1], images.shape[2]]],
                                    dtype=torch.float32, device=images.device)
        default_size = default_size.repeat(batch_size, 1)
        original_size = batch.get("original_size", default_size)
        target_size = batch.get("target_size", default_size)
        crop_coords = batch.get("crop_coords_top_left",
                                torch.zeros_like(default_size))

        model_pred = trainable.denoiser(
            noisy, timesteps, context, original_size, target_size, crop_coords,
            context_mask=batch["context_mask"],
        )
        l2_loss = self._treat_loss(model_pred, noisy, images, noise, timesteps)
        total = l2_loss
        metrics = {"l2_loss": l2_loss.detach()}

        for idx, scale in enumerate(cfg.lowres_loss):
            if scale <= 0.0:
                continue
            lowres_images = _area_downsample(images, scale)
            lowres_noisy = _area_downsample(noisy, scale)
            lowres_noise = _area_downsample(noise, scale)
            lh, lw = lowres_images.shape[1], lowres_images.shape[2]
            lowres_tsize = torch.tensor([[lh, lw]], dtype=torch.float32,
                                        device=images.device).repeat(batch_size, 1)
            lowres_pred = trainable.denoiser(
                lowres_noisy, timesteps, context, original_size * scale,
                lowres_tsize, crop_coords * scale,
                context_mask=batch["context_mask"],
            )
            lowres_l2 = self._treat_loss(lowres_pred, lowres_noisy, lowres_images,
                                         lowres_noise, timesteps)
            metrics[f"lowres_loss_{idx}"] = lowres_l2.detach()
            total = total + lowres_l2
        return total, metrics
