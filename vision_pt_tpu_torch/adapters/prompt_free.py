"""PFG (Prompt-Free Generation) adapter (port of
``vision_pt_tpu/adapters/prompt_free.py``): vision-tower features projected
into pseudo text tokens that are appended to the context sequence. No UNet
surgery: the tokens ride the regular cross-attention. Projectors: linear,
MLP and a perceiver resampler.
"""

from __future__ import annotations

from typing import Literal, NamedTuple

import torch
import torch.nn.functional as F
from pydantic import BaseModel
from torch import nn

from ..ops.attention import plain_attention
from ..ops.linear import Linear
from ..ops.norm import LayerNorm
from .ip_adapter import ImageEncoderConfig, retype_to_adapter_params, to_tensor


class ProjectionOutput(NamedTuple):
    image_tokens: torch.Tensor  # (B, num_image_tokens, context_dim)


class PFGConfig(BaseModel):
    image_encoder: ImageEncoderConfig = ImageEncoderConfig()
    checkpoint_weight: str | None = None

    num_image_tokens: int = 10
    projector_type: Literal["linear", "mlp", "resampler"] = "linear"
    projector_args: dict = {}

    image_size: int = 448
    background_color: int = 255
    color_channel: Literal["rgb", "bgr"] = "rgb"
    image_mean: list[float] = [0.5, 0.5, 0.5]
    image_std: list[float] = [0.5, 0.5, 0.5]


def _linear(din, dout, generator):
    return Linear(din, dout, generator=generator, std=None)


def _pooled(features: torch.Tensor) -> torch.Tensor:
    return features.mean(dim=1) if features.dim() == 3 else features


class LinearProjector(nn.Module):
    """(B, D) pooled features (a sequence is mean-pooled) -> N tokens."""

    def __init__(self, feature_dim: int, out_features: int, num_tokens: int, *,
                 generator=None):
        super().__init__()
        self.num_tokens, self.out_features = num_tokens, out_features
        self.proj = _linear(feature_dim, num_tokens * out_features, generator)

    def forward(self, features: torch.Tensor) -> ProjectionOutput:
        features = _pooled(features)
        tokens = self.proj(features).reshape(features.shape[0], self.num_tokens,
                                             self.out_features)
        return ProjectionOutput(tokens)


class MLPProjector(nn.Module):
    def __init__(self, feature_dim: int, out_features: int, num_tokens: int,
                 hidden_dim: int | None = None, *, generator=None):
        super().__init__()
        self.num_tokens, self.out_features = num_tokens, out_features
        hidden = hidden_dim or feature_dim * 2
        self.fc1 = _linear(feature_dim, hidden, generator)
        self.fc2 = _linear(hidden, num_tokens * out_features, generator)

    def forward(self, features: torch.Tensor) -> ProjectionOutput:
        features = _pooled(features)
        tokens = self.fc2(F.gelu(self.fc1(features))).reshape(
            features.shape[0], self.num_tokens, self.out_features)
        return ProjectionOutput(tokens)


class Resampler(nn.Module):
    """Perceiver style: N learned latents attend to the feature sequence
    (one unmasked attention in the features' dtype)."""

    def __init__(self, feature_dim: int, out_features: int, num_tokens: int,
                 num_heads: int = 8, *, generator=None):
        super().__init__()
        if out_features % num_heads:
            raise ValueError(f"out_features {out_features} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_tokens, self.num_heads, self.out_features = num_tokens, num_heads, out_features
        self.latents = nn.Parameter(
            torch.randn(num_tokens, out_features, generator=generator) * out_features**-0.5)
        self.to_kv = _linear(feature_dim, out_features * 2, generator)
        self.to_q = _linear(out_features, out_features, generator)
        self.to_out = _linear(out_features, out_features, generator)
        self.norm = LayerNorm(out_features)

    def forward(self, features: torch.Tensor) -> ProjectionOutput:
        if features.dim() == 2:
            features = features[:, None, :]
        b, s, _ = features.shape
        h, d = self.num_heads, self.out_features // self.num_heads
        q = self.to_q(self.latents.expand(b, -1, -1)).reshape(b, self.num_tokens, h, d)
        k, v = self.to_kv(features).chunk(2, dim=-1)
        attn = plain_attention(q, k.reshape(b, s, h, d), v.reshape(b, s, h, d))
        out = self.to_out(attn.reshape(b, self.num_tokens, -1))
        return ProjectionOutput(self.norm(out))


_PROJECTORS = {"linear": LinearProjector, "mlp": MLPProjector, "resampler": Resampler}


class PFGManager:
    """The projector's factory and the adapter file's IO (no UNet surgery)."""

    def __init__(self, adapter_config: PFGConfig):
        self.adapter_config = adapter_config
        self.projector: nn.Module | None = None

    def get_projector(self, out_features: int, *,
                      generator: torch.Generator | None = None) -> nn.Module:
        cfg = self.adapter_config
        self.projector = _PROJECTORS[cfg.projector_type](
            feature_dim=cfg.image_encoder.feature_dim, out_features=out_features,
            num_tokens=cfg.num_image_tokens, **cfg.projector_args, generator=generator)
        return self.projector

    def apply_adapter(self, model, **kwargs) -> list[str]:
        """PFG patches no attention: the context concatenation happens in the
        pipeline. Kept for the managers' common interface."""
        return []

    def set_adapter_trainable(self, trainable: bool = True) -> None:
        if trainable and self.projector is not None:
            retype_to_adapter_params(self.projector)

    def get_state_dict(self) -> dict[str, torch.Tensor]:
        """``projector.*`` in the torch layout, on the host."""
        return {f"projector.{k}": v.detach().cpu()
                for k, v in self.projector.state_dict().items()}

    def load_adapter_state(self, sd: dict) -> None:
        proj = {k[len("projector."):]: to_tensor(v) for k, v in sd.items()
                if k.startswith("projector.")}
        self.projector.load_state_dict(proj, strict=False)
