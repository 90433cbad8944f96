"""Style tokenizer adapter (port of ``vision_pt_tpu/adapters/style_tokenizer.py``):
a vision tower's features of a reference image, projected into the
embeddings of N ``<|style|>`` placeholder tokens, one projector per CLIP
text encoder. No UNet surgery: the style rows enter through the text
encoders. The adapter file holds ``projector_{i}.*`` in the torch layout.
"""

from __future__ import annotations

from typing import Literal, NamedTuple

import torch
from pydantic import BaseModel
from torch import nn

from .ip_adapter import ImageEncoderConfig, retype_to_adapter_params, to_tensor
from .prompt_free import LinearProjector, MLPProjector, Resampler


class StyleProjectionOutput(NamedTuple):
    style_tokens: torch.Tensor  # (B, num_style_tokens, text_hidden_dim)


class StyleTokenizerConfig(BaseModel):
    image_encoder: ImageEncoderConfig = ImageEncoderConfig()
    checkpoint_weight: str | None = None

    style_token: str = "<|style|>"
    num_style_tokens: int = 4
    projector_type: Literal["linear", "mlp", "resampler"] = "linear"
    projector_args: dict = {}

    image_size: int = 448
    background_color: int = 255
    image_mean: list[float] = [0.5, 0.5, 0.5]
    image_std: list[float] = [0.5, 0.5, 0.5]


_PROJECTORS = {"linear": LinearProjector, "mlp": MLPProjector, "resampler": Resampler}


class StyleProjector(nn.Module):
    """A PFG projector whose tokens are the style rows."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, features: torch.Tensor) -> StyleProjectionOutput:
        return StyleProjectionOutput(self.inner(features).image_tokens)


class StyleTokenizerManager:
    """The projectors' factory and the adapter file's IO."""

    def __init__(self, adapter_config: StyleTokenizerConfig):
        self.adapter_config = adapter_config
        self.projectors: list[StyleProjector] = []

    def get_projector(self, out_features: int, *,
                      generator: torch.Generator | None = None) -> StyleProjector:
        cfg = self.adapter_config
        proj = StyleProjector(_PROJECTORS[cfg.projector_type](
            feature_dim=cfg.image_encoder.feature_dim, out_features=out_features,
            num_tokens=cfg.num_style_tokens, **cfg.projector_args, generator=generator))
        self.projectors.append(proj)
        return proj

    def apply_adapter(self, model, **kwargs) -> list[str]:
        """No attention is patched. Kept for the managers' common interface."""
        return []

    def set_adapter_trainable(self, trainable: bool = True) -> None:
        if trainable:
            for proj in self.projectors:
                retype_to_adapter_params(proj)

    def get_state_dict(self) -> dict[str, torch.Tensor]:
        """``projector_{i}.*`` (i from 1) in the torch layout, on the host."""
        return {f"projector_{i}.{k}": v.detach().cpu()
                for i, proj in enumerate(self.projectors, start=1)
                for k, v in proj.state_dict().items()}

    def load_adapter_state(self, sd: dict) -> None:
        for i, proj in enumerate(self.projectors, start=1):
            prefix = f"projector_{i}."
            sub = {k[len(prefix):]: to_tensor(v) for k, v in sd.items() if k.startswith(prefix)}
            if sub:
                proj.load_state_dict(sub, strict=False)
