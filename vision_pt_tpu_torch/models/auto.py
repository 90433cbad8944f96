"""Auto image encoder (port of ``vision_pt_tpu/models/auto.py``).

A pluggable image-feature extractor: images (B, H, W, 3), already
normalized -> pooled features (B, feature_dim), or a hidden state. Nothing is
downloaded: it needs local weights (``weights_path``) or an injected encode
function. The key layout of the weights picks the tower: ``blocks.N.*`` a
timm ViT, ``vision_model.*`` a CLIP vision model. The tower is built on the
encoder's device and stays frozen.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from ..utils import resolve_device


class AutoImageEncoder:
    def __init__(self, config, encode_fn: Callable | None = None,
                 device: str | torch.device | None = None):
        self.config = config
        self.device = resolve_device(device)
        self.model: torch.nn.Module | None = None
        self._encode_fn = encode_fn

    def set_encode_fn(self, fn: Callable):
        self._encode_fn = fn

    @staticmethod
    def _sniff_layout(weights_path: str) -> str:
        """'timm' (``blocks.N.*`` keys) or 'clip' (``vision_model.*`` keys),
        read from the checkpoint itself."""
        from pathlib import Path

        from safetensors import safe_open

        p = Path(weights_path)
        files = [p] if p.is_file() else sorted(p.glob("*.safetensors"))
        for f in files:
            with safe_open(str(f), framework="np") as sf:
                for k in sf.keys():
                    if k.startswith("blocks."):
                        return "timm"
                    if "vision_model." in k:
                        return "clip"
        return "clip"

    def _load_model(self):
        weights_path = getattr(self.config, "weights_path", None)
        if not weights_path:
            raise RuntimeError(
                "AutoImageEncoder needs pretrained vision weights "
                f"({getattr(self.config, 'model_name', '?')}) and downloads "
                "nothing: give weights_path (local safetensors: CLIP vision "
                "towers or timm-layout ViTs) or inject encode_fn.")
        if not (os.path.isdir(weights_path) or os.path.isfile(weights_path)):
            raise FileNotFoundError(
                f"weights_path {weights_path!r} not found (expected a "
                "safetensors file or an HF-layout directory)")
        if self._sniff_layout(weights_path) == "timm":
            from .timm_vit import TimmViT

            # the head count is not recoverable from fused-qkv weights
            self.model = TimmViT.from_local(weights_path, device=self.device,
                                            num_heads=getattr(self.config, "num_heads", None))
        else:
            from .clip_vision import CLIPVisionModel

            self.model = CLIPVisionModel.from_local(weights_path, device=self.device)

    def _encode(self, images: torch.Tensor) -> torch.Tensor:
        out = self.model(images)
        if getattr(self.config, "feature_type", "pooler_output") != "hidden_state":
            return out.pooler_output
        hidden = out.hidden_states[getattr(self.config, "hidden_state_index", -1)]
        if getattr(self.model, "cls_token", None) is not None:
            return hidden[:, 1:]  # a timm block's token grid, the class token dropped
        return hidden

    def to(self, device: str | torch.device) -> "AutoImageEncoder":
        self.device = torch.device(device)
        if self.model is not None:
            self.model.to(self.device)
        return self

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        if self._encode_fn is not None:
            return self._encode_fn(images)
        if self.model is None:
            self._load_model()
        return self._encode(images)
