"""timm-layout Vision Transformer (port of ``vision_pt_tpu/models/timm_vit.py``),
the local-weights tower of ``AutoImageEncoder`` for non-CLIP ViTs such as
the WD taggers: fused-qkv pre-norm blocks, optional LayerScale, class-token
or mean pooling, the classifier head dropped.

Loading is weight-driven: depth, width, patch size, grid, LayerScale and
pooling come from the checkpoint's ``blocks.N.*`` keys and shapes. The head
count cannot be recovered from fused qkv weights: 64-d heads unless given.
Pixels are NHWC; attention goes through ``ops.attention.dot_product_attention``
(at ViT-B/16's S 785 at 448^2 the plain path).
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


class TimmViTConfig(BaseModel):
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    patch_size: int = 16
    img_size: int = 224
    mlp_ratio: float = 4.0
    class_token: bool = True
    global_pool: str = "token"  # "token" (class token) | "avg"
    use_layer_scale: bool = False
    layer_norm_eps: float = 1e-6


def _linear(din, dout, **kw):
    return Linear(din, dout, std=None, **kw)


class TimmAttention(nn.Module):
    """timm ``Attention``: fused qkv and the output projection."""

    def __init__(self, dim: int, num_heads: int, **kw):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = _linear(dim, dim * 3, **kw)
        self.proj = _linear(dim, dim, **kw)

    def forward(self, x):
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, self.head_dim)
        out = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(out.reshape(b, n, d))


class TimmMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, **kw):
        super().__init__()
        self.fc1 = _linear(dim, hidden, **kw)
        self.fc2 = _linear(hidden, dim, **kw)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class TimmBlock(nn.Module):
    """Pre-norm residual block, LayerScale (``ls1`` / ``ls2``) optional."""

    def __init__(self, config: TimmViTConfig, **kw):
        super().__init__()
        d = config.embed_dim
        norm = dict(eps=config.layer_norm_eps, dtype=kw["dtype"],
                    param_dtype=kw["param_dtype"])
        self.norm1 = LayerNorm(d, **norm)
        self.attn = TimmAttention(d, config.num_heads, **kw)
        self.norm2 = LayerNorm(d, **norm)
        self.mlp = TimmMlp(d, int(d * config.mlp_ratio), **kw)
        self.ls1 = self.ls2 = None
        if config.use_layer_scale:
            self.ls1 = nn.Parameter(torch.ones(d, dtype=kw["param_dtype"]))
            self.ls2 = nn.Parameter(torch.ones(d, dtype=kw["param_dtype"]))

    def forward(self, x):
        h = self.attn(self.norm1(x))
        if self.ls1 is not None:
            h = h * self.ls1
        x = x + h
        h = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            h = h * self.ls2
        return x + h


class TimmViTOutput(NamedTuple):
    pooler_output: torch.Tensor  # (B, D)
    last_hidden_state: torch.Tensor  # (B, N[+1], D), the final norm applied
    hidden_states: tuple[torch.Tensor, ...]  # each block's, before the final norm


class TimmViT(nn.Module):
    """timm ``VisionTransformer`` without its classifier head. Built on the
    current default device from ``generator``."""

    def __init__(self, config: TimmViTConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        self.config = config
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        d = config.embed_dim
        grid = config.img_size // config.patch_size
        n_prefix = 1 if config.class_token else 0
        self.patch_embed_proj = Conv2d(3, d, config.patch_size, stride=config.patch_size,
                                       **kw)
        self.cls_token = (nn.Parameter(torch.zeros(1, 1, d, dtype=param_dtype))
                          if config.class_token else None)
        self.pos_embed = nn.Parameter(
            0.02 * torch.randn(1, grid * grid + n_prefix, d, generator=generator)
            .to(param_dtype))
        self.blocks = nn.ModuleList(TimmBlock(config, **kw) for _ in range(config.depth))
        self.norm = LayerNorm(d, eps=config.layer_norm_eps, dtype=dtype,
                              param_dtype=param_dtype)

    def forward(self, pixel_values: torch.Tensor) -> TimmViTOutput:
        """pixel_values: (B, H, W, 3), already normalized."""
        x = self.patch_embed_proj(pixel_values)
        b, h, w, d = x.shape
        x = x.reshape(b, h * w, d)
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, d), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        hidden_states = []
        for block in self.blocks:
            x = block(x)
            hidden_states.append(x)
        x = self.norm(x)
        if self.config.global_pool == "avg":
            pooled = x[:, 1 if self.cls_token is not None else 0:].mean(dim=1)
        else:
            pooled = x[:, 0]
        return TimmViTOutput(pooled, x, tuple(hidden_states))

    @classmethod
    def from_local(cls, path: str, *, num_heads: int | None = None, dtype=None,
                   device: str | torch.device = "cpu") -> "TimmViT":
        """Load a directory of timm-layout safetensors (or one file) onto
        ``device``; the shapes give the architecture."""
        from pathlib import Path

        from safetensors.numpy import load_file

        p = Path(path)
        files = [p] if p.is_file() else sorted(p.glob("*.safetensors"))
        sd: dict[str, np.ndarray] = {}
        for f in files:
            sd |= load_file(str(f))
        if not any(k.startswith("blocks.0.") for k in sd):
            raise ValueError(f"{path} does not hold a timm-layout ViT "
                             "(no blocks.N.* keys)")
        with torch.device(device):
            model = cls(infer_timm_vit_config(sd, num_heads=num_heads), dtype=dtype)
        model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in convert_timm_vit(sd).items()},
            strict=False)
        return model.eval().requires_grad_(False)


def infer_timm_vit_config(sd: dict[str, np.ndarray],
                          num_heads: int | None = None) -> TimmViTConfig:
    """The architecture from a timm state dict's shapes."""
    embed_dim, _, patch, _ = sd["patch_embed.proj.weight"].shape  # OIHW
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    hidden = sd["blocks.0.mlp.fc1.weight"].shape[0]
    class_token = "cls_token" in sd
    n_pos = sd["pos_embed"].shape[1] - (1 if class_token else 0)
    grid = int(round(n_pos ** 0.5))
    if num_heads is None:
        num_heads = max(1, embed_dim // 64)  # the timm family's usual 64-d heads
    return TimmViTConfig(
        embed_dim=embed_dim, depth=depth, num_heads=num_heads, patch_size=patch,
        img_size=grid * patch, mlp_ratio=hidden / embed_dim, class_token=class_token,
        global_pool="token" if class_token else "avg",
        use_layer_scale="blocks.0.ls1.gamma" in sd)


def convert_timm_vit(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A timm state dict -> the port's keys (the torch layout stays); keys the
    model does not have (the classifier head) are left for the loader to
    ignore."""
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.startswith("patch_embed.proj."):
            k = "patch_embed_proj." + k.removeprefix("patch_embed.proj.")
        elif k.endswith((".ls1.gamma", ".ls2.gamma")):
            k = k.removesuffix(".gamma")
        out[k] = np.asarray(v)
    return out
