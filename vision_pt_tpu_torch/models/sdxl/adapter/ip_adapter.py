"""SDXL with IP-Adapter (port of ``vision_pt_tpu/models/sdxl/adapter/ip_adapter.py``):
the image encoder, the adapter manager over the UNet's ``attn2`` modules,
the image projector and the reference-image preprocessing, on the SDXL
pipeline.

The adapter file holds ``ip_adapter.<escaped attn2 path>.to_k_ip.weight``
... and ``image_proj.*`` in the torch layout, as the JAX package writes it.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from ....adapters.ip_adapter import (
    IPAdapterConfig,
    IPAdapterManager,
    to_tensor,
    get_ip_adapter_class,
)
from ....data.transforms import ColorChannelSwap, PaddedResize
from ....utils import resolve_device
from ...auto import AutoImageEncoder
from ..config import SDXLConfig
from ..pipeline import SDXLModel


class SDXLModelWithIPAdapterConfig(SDXLConfig):
    adapter: IPAdapterConfig = IPAdapterConfig()


class ReferenceImages:
    """PIL images -> the vision tower's NHWC input: letterboxed to the
    tower's square, optionally BGR, normalized by the tower's mean and std."""

    def __init__(self, config, device: torch.device):
        self.resize = PaddedResize(max_size=config.image_size, fill=config.background_color)
        self.channel_swap = (ColorChannelSwap((2, 1, 0))
                             if getattr(config, "color_channel", "rgb") == "bgr" else None)
        self.mean = np.asarray(config.image_mean, dtype=np.float32)
        self.std = np.asarray(config.image_std, dtype=np.float32)
        self.device = device

    def __call__(self, images) -> torch.Tensor:
        if isinstance(images, Image.Image):
            images = [images]
        arrays = []
        for img in images:
            arr = np.asarray(self.resize(img.convert("RGB")), dtype=np.float32) / 255.0
            if self.channel_swap is not None:
                arr = self.channel_swap(arr)
            arrays.append((arr - self.mean) / self.std)
        return torch.from_numpy(np.stack(arrays)).to(self.device)


class SDXLModelWithIPAdapter(SDXLModel):
    config: SDXLModelWithIPAdapterConfig

    def __init__(self, config: SDXLModelWithIPAdapterConfig, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None, **kw):
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        super().__init__(config, generator=generator, device=device, **kw)
        adapter_cfg = config.adapter
        self.encoder = AutoImageEncoder(adapter_cfg.image_encoder, device=self.device)
        self.manager = IPAdapterManager(get_ip_adapter_class(adapter_cfg.variant),
                                        adapter_cfg)
        with self.device:
            self.image_proj = self.manager.get_projector(config.denoiser.context_dim,
                                                         generator=generator)
        self._reference = ReferenceImages(adapter_cfg, self.device)
        self._adapter_generator = generator

    def init_adapter(self) -> list[str]:
        """Replace every ``attn2`` of the UNet by the configured variant."""
        return self.manager.apply_adapter(self, generator=self._adapter_generator)

    def to(self, device: str | torch.device) -> "SDXLModelWithIPAdapter":
        super().to(device)
        self.image_proj.to(self.device)
        self.encoder.to(self.device)
        self._reference.device = self.device
        return self

    def _load_checkpoint(self, checkpoint_path: str, strict: bool = True):
        """The SDXL checkpoint, then the adapters applied and, with
        ``adapter.checkpoint_weight``, the adapter file loaded over them."""
        super()._load_checkpoint(checkpoint_path, strict=strict)
        self.init_adapter()
        if self.config.adapter.checkpoint_weight:
            from safetensors.numpy import load_file

            self.load_adapter_state_dict(load_file(self.config.adapter.checkpoint_weight))

    def adapter_state_dict(self) -> dict[str, torch.Tensor]:
        """``ip_adapter.*`` + ``image_proj.*``, on the host."""
        out = {f"ip_adapter.{k}": v for k, v in self.manager.get_state_dict().items()}
        out.update({f"image_proj.{k}": v.detach().cpu()
                    for k, v in self.image_proj.state_dict().items()})
        return out

    def load_adapter_state_dict(self, sd: dict) -> None:
        self.manager.load_adapter_state(
            {k[len("ip_adapter."):]: v for k, v in sd.items() if k.startswith("ip_adapter.")})
        proj = {k[len("image_proj."):]: to_tensor(v) for k, v in sd.items()
                if k.startswith("image_proj.")}
        if proj:
            self.image_proj.load_state_dict(proj, strict=False)

    # ---------------------------------------------------------- images

    def preprocess_reference_images(self, images) -> torch.Tensor:
        return self._reference(images)

    def encode_reference_images(self, images) -> torch.Tensor:
        """Images (PIL, or the tower's input) -> ip tokens (B, N, context)."""
        pixel_values = (images if isinstance(images, torch.Tensor)
                        else self.preprocess_reference_images(images))
        with torch.no_grad():
            features = self.encoder(pixel_values)
        return self.image_proj(features)

    # ---------------------------------------------------------- generate

    def generate(self, prompt, *args, reference_images=None, ip_tokens=None, **kwargs):
        """SDXL sampling with image tokens on every ``attn2``; under CFG the
        negative half gets zero tokens."""
        if ip_tokens is None and reference_images is not None:
            with torch.inference_mode():
                ip_tokens = self.encode_reference_images(reference_images)
        if ip_tokens is not None:
            if kwargs.get("cfg_scale", 3.5) > 1.0:
                ip_tokens = torch.cat([ip_tokens, torch.zeros_like(ip_tokens)])
            kwargs["cross_attention_kwargs"] = {"ip_tokens": ip_tokens}
        return super().generate(prompt, *args, **kwargs)
