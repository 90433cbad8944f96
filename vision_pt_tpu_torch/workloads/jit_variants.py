"""JiT variant training workloads (port of
``vision_pt_tpu/workloads/jit_variants.py``).

``JiTForArbClassToImageTraining`` takes the per-sample size conditioning from
the batch (aspect-ratio buckets, cached latents) and adds the optional
multi-resolution ``lowres_loss`` terms. The U-JiT (square and ARB), Cross,
IG, LoIG and TREAD workloads swap the model class and, where the JAX package
does, add their loss terms. TREAD's route permutation is one of the step's
draws (``route_perm``), so a test can hand in the JAX package's.

Each runs under ``trainer.mesh`` over data, fsdp, tensor and seq, as the
base workload does: the per-sample timesteps and noise (and the batch's
size fields) are split by rows, TREAD's permutation stays whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.jit.extension.cross import CrossJiTDenoiserConfig, CrossJiTModel
from ..models.jit.extension.ig import IGJiTDenoiserConfig, IGJiTModel
from ..models.jit.extension.loig import LoIGJiTDenoiserConfig, LoIGJiTModel
from ..models.jit.extension.tread import (
    JiTWithTreadDenoiserConfig,
    JiTWithTreadModel,
)
from ..models.jit.extension.uvit import UJiTDenoiserConfig, UJiTModel
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
        context, timesteps, noisy, noise, default_size = self._step_inputs(
            trainable, batch, draws)
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



# ------------------------------------------------------------------- U-JiT


class UJiTConfigForTraining(JiTConfigForTraining):
    denoiser: UJiTDenoiserConfig = UJiTDenoiserConfig()


class JiTForUJiTTraining(JiTForClassToImageTraining):
    model_class = UJiTModel
    model_config_class = UJiTConfigForTraining


class ArbUJiTConfigForTraining(JiTConfigForArbTraining):
    denoiser: UJiTDenoiserConfig = UJiTDenoiserConfig()


class JiTForArbUJiTTraining(JiTForArbClassToImageTraining):
    model_class = UJiTModel
    model_config_class = ArbUJiTConfigForTraining


# ------------------------------------------------------------------- cross


class CrossJiTConfigForTraining(JiTConfigForTraining):
    denoiser: CrossJiTDenoiserConfig = CrossJiTDenoiserConfig()


class JiTForCrossTraining(JiTForClassToImageTraining):
    model_class = CrossJiTModel
    model_config_class = CrossJiTConfigForTraining


# ------------------------------------------------------------------- IG


class IGJiTConfigForTraining(JiTConfigForTraining):
    denoiser: IGJiTDenoiserConfig = IGJiTDenoiserConfig()
    ig_scale: float = 1.0
    intermediate_loss_weight: float = 0.5


class JiTForIGTraining(JiTForClassToImageTraining):
    """Internal-guidance training: the main head's target is the image plus
    ``ig_scale`` times the detached gap between the two heads; the
    intermediate head is trained toward the clean image."""

    model_class = IGJiTModel
    model_config_class = IGJiTConfigForTraining

    def compute_loss(self, trainable, batch: dict, draws: dict):
        cfg = self.model_config
        images = batch["image"]
        context, timesteps, noisy, noise, size = self._step_inputs(
            trainable, batch, draws)
        model_pred, intermediate_pred = trainable.denoiser(
            noisy, timesteps, context, size, size, torch.zeros_like(size),
            context_mask=batch["context_mask"],
        )
        guided_clean = images + cfg.ig_scale * (model_pred - intermediate_pred).detach()
        l2_loss = self._treat_loss(model_pred, noisy, guided_clean, noise, timesteps)
        inter_loss = self._treat_loss(intermediate_pred, noisy, images, noise,
                                      timesteps)
        total = l2_loss + cfg.intermediate_loss_weight * inter_loss
        return total, {"l2_loss": l2_loss.detach(),
                       "intermediate_l2_loss": inter_loss.detach()}


# ------------------------------------------------------------------- LoIG


class LoIGJiTConfigForTraining(JiTConfigForTraining):
    denoiser: LoIGJiTDenoiserConfig = LoIGJiTDenoiserConfig()
    loig_loss_weight: float = 1.0


class JiTForLoIGTraining(JiTForClassToImageTraining):
    """Low-rank internal guidance: both heads are trained toward the clean
    image."""

    model_class = LoIGJiTModel
    model_config_class = LoIGJiTConfigForTraining

    def compute_loss(self, trainable, batch: dict, draws: dict):
        cfg = self.model_config
        images = batch["image"]
        context, timesteps, noisy, noise, size = self._step_inputs(
            trainable, batch, draws)
        model_pred, weak_pred = trainable.denoiser(
            noisy, timesteps, context, size, size, torch.zeros_like(size),
            context_mask=batch["context_mask"],
        )
        l2_loss = self._treat_loss(model_pred, noisy, images, noise, timesteps)
        loig_loss = self._treat_loss(weak_pred, noisy, images, noise, timesteps)
        total = l2_loss + cfg.loig_loss_weight * loig_loss
        return total, {"l2_loss": l2_loss.detach(),
                       "loig_l2_loss": loig_loss.detach()}


# ------------------------------------------------------------------- TREAD


class TreadJiTConfigForTraining(JiTConfigForTraining):
    denoiser: JiTWithTreadDenoiserConfig = JiTWithTreadDenoiserConfig()


class JiTForTreadTraining(JiTForClassToImageTraining):
    """TREAD token-routing training; the routing runs only in the training
    step, with the permutation drawn beside the timesteps and noise. The
    permutation is one for the whole batch: under a mesh every rank draws
    the same one and keeps it whole."""
    mesh_whole_draws = ("route_perm",)

    model_class = JiTWithTreadModel
    model_config_class = TreadJiTConfigForTraining

    def draw_randoms(self, batch: dict, generator: torch.Generator) -> dict:
        draws = super().draw_randoms(batch, generator)
        images = batch["image"]
        n = self.model.denoiser.num_patches(images.shape[1], images.shape[2])
        draws["route_perm"] = torch.randperm(n, generator=generator,
                                             device=images.device)
        return draws

    def compute_loss(self, trainable, batch: dict, draws: dict):
        images = batch["image"]
        context, timesteps, noisy, noise, size = self._step_inputs(
            trainable, batch, draws)
        model_pred = trainable.denoiser(
            noisy, timesteps, context, size, size, torch.zeros_like(size),
            context_mask=batch["context_mask"], route_perm=draws["route_perm"],
        )
        l2_loss = self._treat_loss(model_pred, noisy, images, noise, timesteps)
        return l2_loss, {"l2_loss": l2_loss.detach()}
