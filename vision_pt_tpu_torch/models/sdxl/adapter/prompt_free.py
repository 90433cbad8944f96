"""SDXL with PFG (port of ``vision_pt_tpu/models/sdxl/adapter/prompt_free.py``).

A vision tower encodes a reference image; the projector turns its features
into ``num_image_tokens`` pseudo context tokens appended to the text
embeddings along the sequence axis. No UNet surgery: the tokens ride the
regular cross-attention.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from ....adapters.prompt_free import PFGConfig, PFGManager
from ....utils import resolve_device
from ...auto import AutoImageEncoder
from ..config import SDXLConfig
from ..pipeline import SDXLModel
from .ip_adapter import ReferenceImages


class SDXLModelWithPFGConfig(SDXLConfig):
    adapter: PFGConfig = PFGConfig()


class SDXLModelWithPFG(SDXLModel):
    config: SDXLModelWithPFGConfig

    def __init__(self, config: SDXLModelWithPFGConfig, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None, **kw):
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        super().__init__(config, generator=generator, device=device, **kw)
        adapter_cfg = config.adapter
        self.vision_encoder = AutoImageEncoder(adapter_cfg.image_encoder, device=self.device)
        self.manager = PFGManager(adapter_config=adapter_cfg)
        with self.device:
            self.projector = self.manager.get_projector(config.denoiser.context_dim,
                                                        generator=generator)
        self._reference = ReferenceImages(adapter_cfg, self.device)

    def init_adapter(self) -> list[str]:
        return self.manager.apply_adapter(self)

    def to(self, device: str | torch.device) -> "SDXLModelWithPFG":
        super().to(device)
        self.projector.to(self.device)
        self.vision_encoder.to(self.device)
        self._reference.device = self.device
        return self

    def _load_checkpoint(self, checkpoint_path: str, strict: bool = True):
        super()._load_checkpoint(checkpoint_path, strict=strict)
        if self.config.adapter.checkpoint_weight:
            from safetensors.numpy import load_file

            self.manager.load_adapter_state(load_file(self.config.adapter.checkpoint_weight))

    def adapter_state_dict(self) -> dict[str, torch.Tensor]:
        return self.manager.get_state_dict()

    # ---------------------------------------------------------- images

    def preprocess_reference_image(self, images) -> torch.Tensor:
        """PIL images, or NHWC arrays in [0, 1] or [-1, 1] (told apart by
        their minimum) -> the tower's normalized input."""
        if isinstance(images, Image.Image):
            images = [images]
        if not isinstance(images, (torch.Tensor, np.ndarray)):
            return self._reference(images)
        arr = torch.as_tensor(images, device=self.device).float()
        if arr.dim() == 3:
            arr = arr[None]
        if float(arr.min()) < -0.01:  # [-1, 1] -> [0, 1]
            arr = (arr + 1.0) / 2.0
        if self._reference.channel_swap is not None:
            arr = arr[..., [2, 1, 0]]
        mean = torch.as_tensor(self._reference.mean, device=self.device)
        std = torch.as_tensor(self._reference.std, device=self.device)
        return (arr - mean) / std

    def encode_reference_image(self, pixel_values: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            features = self.vision_encoder(pixel_values)
        return self.projector(features).image_tokens

    # ---------------------------------------------------------- generate

    def generate(self, prompt, *args, reference_image=None, image_tokens=None, **kwargs):
        """SDXL sampling with the image tokens appended to the positive
        context; under CFG the negative half gets zero tokens."""
        if image_tokens is None and reference_image is not None:
            with torch.inference_mode():
                pixels = (reference_image if isinstance(reference_image, torch.Tensor)
                          else self.preprocess_reference_image(reference_image))
                image_tokens = self.encode_reference_image(pixels)
        if image_tokens is not None:
            batch = len(prompt) if isinstance(prompt, list) else 1
            if image_tokens.shape[0] == 1 and batch > 1:
                image_tokens = image_tokens.repeat(batch, 1, 1)
            if kwargs.get("cfg_scale", 3.5) > 1.0:
                image_tokens = torch.cat([image_tokens, torch.zeros_like(image_tokens)])
            kwargs["extra_context_tokens"] = image_tokens
        return super().generate(prompt, *args, **kwargs)
