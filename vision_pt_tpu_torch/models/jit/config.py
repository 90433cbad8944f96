"""JiT model configs (the port's own copy of
``vision_pt_tpu/models/jit/config.py``)."""

from __future__ import annotations

import json
from typing import Literal

import torch
from pydantic import BaseModel

from ...utils.dtype import str_to_dtype

PositionalEncoding = Literal["rope", "pope", "n-pope"]
NormType = Literal["layer", "rms", "dyt", "derf"]
ModelPredictionType = Literal["noise", "velocity", "image"]


class DenoiserConfig(BaseModel):
    patch_size: int = 16
    in_channels: int = 3
    out_channels: int = 3
    hidden_size: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    attn_dropout: float = 0.0
    proj_dropout: float = 0.0

    bottleneck_dim: int = 128
    use_output_bottleneck: bool = False
    use_pixel_shuffle: bool = False

    norm_type: NormType = "rms"

    num_time_tokens: int = 4
    timestep_scale: float = 1.0  # or 1000.0 like diffusion

    positional_encoding: PositionalEncoding = "rope"
    rope_theta: float = 256.0
    rope_axes_dims: list[int] = [16, 24, 24]
    rope_axes_lens: list[int] = [256, 128, 128]
    rope_zero_centered: list[bool] = [False, True, True]
    rope_do_normalize: list[bool] = [False, True, True]
    rope_normalize_by: float = 64.0

    context_dim: int = 768
    context_start_block: int = 0
    do_context_fuse: bool = False


class JiT_B_16_Config(DenoiserConfig):
    patch_size: int = 16
    depth: int = 12
    hidden_size: int = 768
    num_heads: int = 12
    bottleneck_dim: int = 128
    context_dim: int = 768
    context_start_block: int = 4
    rope_axes_dims: list[int] = [16, 24, 24]
    rope_axes_lens: list[int] = [256, 128, 128]


class ClassContextConfig(BaseModel):
    type: Literal["class"] = "class"
    label2id_map_path: str

    splitter: str = " "
    do_mask_padding: bool = True

    @property
    def label2id(self) -> dict[str, int]:
        with open(self.label2id_map_path) as f:
            return json.load(f)


class TextContextConfig(BaseModel):
    type: Literal["text"] = "text"
    pretrained_model: str = "p1atdev/Qwen3-VL-2B-Instruct-Text-Only"


ContextConfig = ClassContextConfig | TextContextConfig


class JiTConfig(BaseModel):
    dtype: str = "float32"

    context_encoder: ContextConfig
    denoiser: DenoiserConfig = JiT_B_16_Config()

    model_pred: ModelPredictionType = "image"

    @property
    def torch_dtype(self) -> torch.dtype:
        return str_to_dtype(self.dtype)
