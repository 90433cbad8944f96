"""SDXL PFG training (port of ``vision_pt_tpu/workloads/sdxl_prompt_free.py``).

Self: the training image itself is the reference; Ref: the batch carries a
separate ``reference_image``. The projector's tokens of the frozen vision
tower's features are appended to the text context. The projector always
trains (AdapterParams); with ``peft`` set, LoRA on the UNet trains beside it
and is saved under the comfy keys. A batch's image-drop draws come from
``np.random.default_rng(seed + 11)``, as in the JAX package; the step's other
draws (the timesteps uniform or gaussian) from ``draw_randoms``, so a test
can hand in others.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch
from PIL import Image
from torch import nn

from ..adapters.ip_adapter import retype_to_adapter_params
from ..models.sdxl.adapter.prompt_free import SDXLModelWithPFG, SDXLModelWithPFGConfig
from ..models.sdxl.convert import convert_to_comfy_key
from ..ops.loss.diffusion import loss_with_predicted_noise, prepare_noised_latents
from ..ops.timestep.sampling import gaussian_randint, uniform_randint
from ..peft import freeze_all_but_adapters, get_adapter_parameters
from .sdxl_ip_adapter import drop_image, resize_images
from .sdxl_text_to_image import SDXLForTextToImageTraining, SDXLForTextToImageTrainingConfig


class SDXLModelWithPFGTrainingConfig(SDXLForTextToImageTrainingConfig,
                                     SDXLModelWithPFGConfig):
    max_token_length: int = 75
    drop_image_rate: float = 0.1
    freeze_vision_encoder: bool = True
    timestep_sampling: Literal["uniform", "gaussian"] = "uniform"
    timestep_sampling_args: dict = {}


class PFGTrainable(nn.Module):
    def __init__(self, denoiser, projector, text_encoder_1, text_encoder_2, vae):
        super().__init__()
        self.denoiser = denoiser
        self.projector = projector
        self.text_encoder = nn.ModuleDict(dict(text_encoder_1=text_encoder_1,
                                               text_encoder_2=text_encoder_2))
        self.vae = vae


class SDXLPFGSelfTraining(SDXLForTextToImageTraining):
    model: SDXLModelWithPFG
    model_config: SDXLModelWithPFGTrainingConfig
    model_config_class = SDXLModelWithPFGTrainingConfig
    pipeline_class = SDXLModelWithPFG

    def setup_model(self):
        if not self.model_config.freeze_vision_encoder:
            raise NotImplementedError(
                "training the vision tower needs local pretrained weights; only "
                "freeze_vision_encoder=True is supported")
        super().setup_model()
        retype_to_adapter_params(self.model.projector)  # the projector always trains
        self._full_trainable = PFGTrainable(
            self.model.denoiser, self.model.projector,
            self.model.text_encoder.text_encoder_1,
            self.model.text_encoder.text_encoder_2, self.model.vae)
        freeze_all_but_adapters(self._full_trainable)
        self._is_peft = True
        self._drop_rng = np.random.default_rng(self.config.seed + 11)

    def sample_timesteps(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """``timestep_sampling``: uniform or gaussian integers."""
        args = self.model_config.timestep_sampling_args
        bounds = dict(min_timesteps=args.get("min_timesteps", 0),
                      max_timesteps=args.get("max_timesteps", 1000), device=self.device)
        if self.model_config.timestep_sampling == "gaussian":
            return gaussian_randint(generator, batch_size, mean=args.get("mean", 100),
                                    std=args.get("std", 100), **bounds)
        return uniform_randint(generator, batch_size, **bounds)

    def _reference_pixels(self, source: torch.Tensor) -> torch.Tensor:
        """NHWC images -> the vision tower's input."""
        resized = resize_images(source, self.model_config.adapter.image_size)
        return self.model.preprocess_reference_image(resized)

    def prepare_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        arrays = super().prepare_batch(batch)
        ref = batch.get("reference_image")
        source = (arrays["image"] if ref is None
                  else torch.as_tensor(np.asarray(ref)).to(self.device))
        arrays["reference_pixels"] = self._reference_pixels(source)
        arrays["drop_image"] = drop_image(self._drop_rng, self.model_config.drop_image_rate,
                                          arrays["image"].shape[0], self.device)
        return arrays

    def compute_loss(self, trainable: nn.Module, batch: dict, draws: dict):
        images = batch["image"]
        vae = self.model.vae
        with torch.no_grad():
            ehs, pooled = self._encode_text(trainable, batch["ids1"], batch["ids2"],
                                            images.shape[0])
            latents = (vae.encode(images).sample(noise=draws["vae_noise"])
                       * vae.scaling_factor)
            features = self.model.vision_encoder(batch["reference_pixels"])
        timesteps = draws["timesteps"]
        noisy, noise = prepare_noised_latents(None, latents, timesteps, draw=draws["noise"])
        image_tokens = trainable.projector(features).image_tokens
        image_tokens = torch.where(batch["drop_image"][:, None, None], 0.0, image_tokens)
        ehs = torch.cat([ehs, image_tokens.to(ehs.dtype)], dim=1)
        noise_pred = trainable.denoiser(
            noisy, timesteps.float(), ehs, pooled, batch["original_size"],
            batch["target_size"], batch["crop_coords_top_left"])
        l2_loss = loss_with_predicted_noise(latents, noise, noise_pred)
        return l2_loss, {"l2_loss": l2_loss.detach()}

    # ------------------------------------------------------------ save

    def get_state_dict_to_save(self) -> dict[str, torch.Tensor]:
        sd = self.model.adapter_state_dict()
        if self.config.peft is not None:
            lora = get_adapter_parameters(self._full_trainable.denoiser)
            sd |= {convert_to_comfy_key(k): v for k, v in lora.items()}
        return sd

    def get_metadata_to_save(self) -> dict[str, str]:
        cfg = self.model_config.adapter
        if cfg.projector_type == "resampler":
            return {"num_heads": str(cfg.projector_args.get("num_heads", 8))}
        return {}

    def preview_step(self, preview_args, preview_index: int) -> list[Image.Image]:
        reference_image = None
        if path := (preview_args.extra or {}).get("reference_image_path"):
            reference_image = Image.open(path).convert("RGB")
        return self.model.generate(
            prompt=preview_args.prompt,
            negative_prompt=preview_args.negative_prompt or "",
            reference_image=reference_image, width=preview_args.width,
            height=preview_args.height, num_inference_steps=preview_args.num_steps,
            cfg_scale=preview_args.cfg_scale, seed=preview_args.seed,
            max_token_length=self.model_config.max_token_length)


class SDXLPFGRefTraining(SDXLPFGSelfTraining):
    """Reference-image variant: the batch carries ``reference_image``."""
