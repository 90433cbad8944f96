"""CLIP vision tower (port of ``vision_pt_tpu/models/clip_vision.py``), the
image encoder behind IP-Adapter and PFG.

Module paths are the JAX package's (HF's ``vision_model.embeddings.
patch_embedding`` ..., HF's ``pre_layrnorm`` typo included, ``layers``
for HF's ``encoder.layers``), so an HF state dict loads after
``convert_hf_clip_vision``. As in HF's ``CLIPVisionTransformer``: the pooled
output is post_layernorm(class token); last_hidden_state is taken before
that norm; every hidden state is kept for ``hidden_state_index``. Pixels are
NHWC. Attention goes through ``ops.attention.dot_product_attention`` (at
S 257 the plain path).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from pydantic import BaseModel
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.linear import Conv2d, Linear
from ..ops.norm import LayerNorm
from .sdxl.text_encoder import Embed, quick_gelu


class CLIPVisionConfig(BaseModel):
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"  # "quick_gelu" for ViT-L
    projection_dim: int = 1024


def _act(name: str):
    if name == "quick_gelu":
        return quick_gelu
    return F.gelu


def _linear(din, dout, *, use_bias=True, **kw):
    return Linear(din, dout, use_bias=use_bias, std=None, **kw)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, config: CLIPVisionConfig, **kw):
        super().__init__()
        d = config.hidden_size
        generator = kw.get("generator")
        self.class_embedding = nn.Parameter(
            torch.randn(d, generator=generator, dtype=kw["param_dtype"]) * 0.02)
        self.patch_embedding = Conv2d(config.num_channels, d, config.patch_size,
                                      stride=config.patch_size, use_bias=False, **kw)
        num_pos = (config.image_size // config.patch_size) ** 2 + 1
        self.position_embedding = Embed(num_pos, d, **kw)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values: (B, H, W, 3)."""
        b = pixel_values.shape[0]
        patches = self.patch_embedding(pixel_values)
        patches = patches.reshape(b, -1, patches.shape[-1])
        cls = self.class_embedding.to(patches.dtype).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)[None]
        return x + self.position_embedding(pos)


class CLIPVisionMLP(nn.Module):
    def __init__(self, config: CLIPVisionConfig, **kw):
        super().__init__()
        self.fc1 = _linear(config.hidden_size, config.intermediate_size, **kw)
        self.fc2 = _linear(config.intermediate_size, config.hidden_size, **kw)
        self.act = _act(config.hidden_act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPVisionAttention(nn.Module):
    def __init__(self, config: CLIPVisionConfig, **kw):
        super().__init__()
        d = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = d // self.num_heads
        self.q_proj = _linear(d, d, **kw)
        self.k_proj = _linear(d, d, **kw)
        self.v_proj = _linear(d, d, **kw)
        self.out_proj = _linear(d, d, **kw)

    def forward(self, x):
        b, s, _ = x.shape
        shape = (b, s, self.num_heads, self.head_dim)
        q = self.q_proj(x).reshape(shape)
        k = self.k_proj(x).reshape(shape)
        v = self.v_proj(x).reshape(shape)
        attn = dot_product_attention(q, k, v)
        return self.out_proj(attn.to(x.dtype).reshape(b, s, -1))


class CLIPVisionLayer(nn.Module):
    def __init__(self, config: CLIPVisionConfig, **kw):
        super().__init__()
        norm = dict(eps=config.layer_norm_eps, dtype=kw["dtype"],
                    param_dtype=kw["param_dtype"])
        self.self_attn = CLIPVisionAttention(config, **kw)
        self.layer_norm1 = LayerNorm(config.hidden_size, **norm)
        self.mlp = CLIPVisionMLP(config, **kw)
        self.layer_norm2 = LayerNorm(config.hidden_size, **norm)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPVisionOutput(NamedTuple):
    last_hidden_state: torch.Tensor
    pooler_output: torch.Tensor
    hidden_states: tuple[torch.Tensor, ...]  # the embeddings, then each layer's
    image_embeds: torch.Tensor | None  # the projected pooled output


class VisionTransformer(nn.Module):
    """HF ``CLIPVisionModel.vision_model``."""

    def __init__(self, config: CLIPVisionConfig, **kw):
        super().__init__()
        norm = dict(eps=config.layer_norm_eps, dtype=kw["dtype"],
                    param_dtype=kw["param_dtype"])
        self.embeddings = CLIPVisionEmbeddings(config, **kw)
        self.pre_layrnorm = LayerNorm(config.hidden_size, **norm)  # HF's name
        self.layers = nn.ModuleList(CLIPVisionLayer(config, **kw)
                                    for _ in range(config.num_hidden_layers))
        self.post_layernorm = LayerNorm(config.hidden_size, **norm)


class CLIPVisionModel(nn.Module):
    """The CLIP vision encoder, with an optional projection head. Built on
    the current default device from ``generator``."""

    def __init__(self, config: CLIPVisionConfig, with_projection: bool = False, *,
                 dtype=None, param_dtype=torch.float32, generator=None):
        super().__init__()
        self.config = config
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.vision_model = VisionTransformer(config, **kw)
        self.visual_projection = (
            _linear(config.hidden_size, config.projection_dim, use_bias=False, **kw)
            if with_projection else None)

    def forward(self, pixel_values: torch.Tensor) -> CLIPVisionOutput:
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixel_values))
        hidden_states = [x]
        for layer in vm.layers:
            x = layer(x)
            hidden_states.append(x)
        pooled = vm.post_layernorm(x[:, 0, :])
        image_embeds = (self.visual_projection(pooled)
                        if self.visual_projection is not None else None)
        return CLIPVisionOutput(x, pooled, tuple(hidden_states), image_embeds)

    @classmethod
    def from_local(cls, path: str, with_projection: bool = False, *, dtype=None,
                   device: str | torch.device = "cpu") -> "CLIPVisionModel":
        """Load from a local HF directory (config.json + safetensors) onto
        ``device``. A key missing from config.json takes the JAX package's
        default (ViT-H/14's sizes and ``gelu``), so ViT-L/14's must be
        written."""
        import json
        from pathlib import Path

        from safetensors.numpy import load_file

        d = Path(path)
        hf = json.loads((d / "config.json").read_text())
        hf = hf.get("vision_config", hf)
        config = CLIPVisionConfig(**{k: hf[k] for k in CLIPVisionConfig.model_fields
                                     if k in hf and k != "num_channels"})
        with torch.device(device):
            model = cls(config, with_projection=with_projection, dtype=dtype)
        sd: dict[str, np.ndarray] = {}
        for f in sorted(d.glob("*.safetensors")):
            sd |= load_file(str(f))
        model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in convert_hf_clip_vision(sd).items()},
            strict=False)
        return model.eval().requires_grad_(False)


def convert_hf_clip_vision(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """An HF CLIP vision state dict -> the port's keys (the torch layout
    stays: only HF's ``encoder.layers`` and an outer ``clip.`` change)."""
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        k = k.removeprefix("clip.")
        if not (k.startswith("vision_model.") or k.startswith("visual_projection")):
            continue
        out[k.replace(".encoder.layers.", ".layers.")] = np.asarray(v)
    return out
