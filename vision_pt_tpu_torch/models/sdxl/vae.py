"""SDXL KL VAE (port of ``vision_pt_tpu/models/sdxl/vae.py``).

NHWC throughout; module paths mirror the diffusers key names
(``encoder.down_blocks.N.resnets.M...``) so checkpoints load through the
converters. The bottleneck attention is single-head over every latent
position (16,384 tokens at 1024^2, C = 512): a plain product, as in the JAX
package, not a kernel. Tiled decode serves large images.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import _exact_tf32
from ...ops.linear import Conv2d, Linear
from ...ops.norm import GroupNorm
from .denoiser import upsample_nearest

VAE_COMPRESSION_RATIO = 8
VAE_SCALING_FACTOR = 0.13025
VAE_SHIFT_FACTOR = 0.0

DEFAULT_VAE_CONFIG = dict(
    block_out_channels=(128, 256, 512, 512),
    in_channels=3,
    latent_channels=4,
    layers_per_block=2,
    norm_num_groups=32,
    out_channels=3,
    scaling_factor=VAE_SCALING_FACTOR,
)


def _conv(cin, cout, k, stride=1, padding=1, *, dtype, param_dtype, generator):
    return Conv2d(cin, cout, k, stride, padding, dtype=dtype,
                  param_dtype=param_dtype, generator=generator)


def _norm(channels, groups, dtype, param_dtype):
    return GroupNorm(channels, groups, eps=1e-6, dtype=dtype, param_dtype=param_dtype)


class ResnetBlock(nn.Module):
    """diffusers ResnetBlock2D (VAE flavour, no time embedding)."""

    def __init__(self, cin, cout, groups=32, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.norm1 = _norm(cin, groups, dtype, param_dtype)
        self.conv1 = _conv(cin, cout, 3, padding=1, **kw)
        self.norm2 = _norm(cout, groups, dtype, param_dtype)
        self.conv2 = _conv(cout, cout, 3, padding=1, **kw)
        self.conv_shortcut = _conv(cin, cout, 1, padding=0, **kw) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention with a residual (diffusers
    Attention with residual_connection=True)."""

    def __init__(self, channels, groups=32, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator, std=None)
        self.group_norm = _norm(channels, groups, dtype, param_dtype)
        self.to_q = Linear(channels, channels, **kw)
        self.to_k = Linear(channels, channels, **kw)
        self.to_v = Linear(channels, channels, **kw)
        self.to_out = Linear(channels, channels, **kw)
        self.scale = channels**-0.5

    def forward(self, x):
        b, h, w, c = x.shape
        tokens = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.to_q(tokens), self.to_k(tokens), self.to_v(tokens)
        with _exact_tf32(q.dtype, q.device):  # fp32 logits of q, k
            logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * self.scale
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bqk,bkc->bqc", weights, v)
        return self.to_out(out).reshape(b, h, w, c) + x


class DownEncoderBlock(nn.Module):
    def __init__(self, cin, cout, layers, has_downsample, groups, *,
                 dtype=None, param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.resnets = nn.ModuleList(
            ResnetBlock(cin if i == 0 else cout, cout, groups, **kw)
            for i in range(layers))
        # the diffusers VAE downsampler: a stride-2 conv with asymmetric
        # (0, 1) padding
        self.downsampler = (
            _conv(cout, cout, 3, stride=2, padding=((0, 1), (0, 1)), **kw)
            if has_downsample else None
        )

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        return self.downsampler(x) if self.downsampler is not None else x


class UpDecoderBlock(nn.Module):
    def __init__(self, cin, cout, layers, has_upsample, groups, *,
                 dtype=None, param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.resnets = nn.ModuleList(
            ResnetBlock(cin if i == 0 else cout, cout, groups, **kw)
            for i in range(layers))
        self.upsampler = _conv(cout, cout, 3, padding=1, **kw) if has_upsample else None

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsampler is not None:
            x = self.upsampler(upsample_nearest(x))
        return x


class MidBlock(nn.Module):
    def __init__(self, channels, groups, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels, groups, **kw),
                                      ResnetBlock(channels, channels, groups, **kw)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups, **kw)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, in_channels, block_out_channels, layers_per_block,
                 latent_channels, groups, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.conv_in = _conv(in_channels, block_out_channels[0], 3, padding=1, **kw)
        blocks, cin = [], block_out_channels[0]
        for i, cout in enumerate(block_out_channels):
            blocks.append(DownEncoderBlock(
                cin, cout, layers_per_block,
                has_downsample=i != len(block_out_channels) - 1, groups=groups, **kw))
            cin = cout
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(block_out_channels[-1], groups, **kw)
        self.conv_norm_out = _norm(block_out_channels[-1], groups, dtype, param_dtype)
        self.conv_out = _conv(block_out_channels[-1], 2 * latent_channels, 3,
                              padding=1, **kw)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, out_channels, block_out_channels, layers_per_block,
                 latent_channels, groups, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        channels = list(reversed(block_out_channels))
        self.conv_in = _conv(latent_channels, channels[0], 3, padding=1, **kw)
        self.mid_block = MidBlock(channels[0], groups, **kw)
        blocks, cin = [], channels[0]
        for i, cout in enumerate(channels):
            blocks.append(UpDecoderBlock(
                cin, cout, layers_per_block + 1,
                has_upsample=i != len(channels) - 1, groups=groups, **kw))
            cin = cout
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = _norm(channels[-1], groups, dtype, param_dtype)
        self.conv_out = _conv(channels[-1], out_channels, 3, padding=1, **kw)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """mean + std * noise, the standard-normal noise given or drawn from
        ``generator``."""
        std = torch.exp(0.5 * torch.clamp(self.logvar, -30.0, 20.0))
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + std * noise.to(self.mean.device, self.mean.dtype)

    @property
    def mode(self) -> torch.Tensor:
        return self.mean


class VAE(nn.Module):
    """AutoencoderKL (SDXL config; scaling 0.13025)."""

    shift_factor = VAE_SHIFT_FACTOR
    # one FSDP unit (parallel.mesh), gathered by these as by a forward
    fsdp_forward_methods = ("encode", "decode")

    def __init__(self, block_out_channels=(128, 256, 512, 512), in_channels=3,
                 out_channels=3, latent_channels=4, layers_per_block=2,
                 norm_num_groups=32, scaling_factor=VAE_SCALING_FACTOR, *,
                 dtype=None, param_dtype=torch.float32, generator=None, **_unused):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.scaling_factor = scaling_factor
        self.latent_channels = latent_channels
        self.compression_ratio = 2 ** (len(block_out_channels) - 1)
        self.encoder = Encoder(in_channels, block_out_channels, layers_per_block,
                               latent_channels, norm_num_groups, **kw)
        self.decoder = Decoder(out_channels, block_out_channels, layers_per_block,
                               latent_channels, norm_num_groups, **kw)
        self.quant_conv = _conv(2 * latent_channels, 2 * latent_channels, 1,
                                padding=0, **kw)
        self.post_quant_conv = _conv(latent_channels, latent_channels, 1,
                                     padding=0, **kw)

    @classmethod
    def from_default(cls, **kw) -> "VAE":
        return cls(**DEFAULT_VAE_CONFIG, **kw)

    def encode(self, images: torch.Tensor) -> DiagonalGaussian:
        """NHWC images in [-1, 1] -> the latent distribution (before
        scaling)."""
        mean, logvar = self.quant_conv(self.encoder(images)).chunk(2, dim=-1)
        return DiagonalGaussian(mean, logvar)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents already divided by the scaling factor -> NHWC images."""
        return self.decoder(self.post_quant_conv(latents))

    def tiled_decode(self, latents: torch.Tensor, tile_latent_size: int = 128,
                     overlap: float = 0.25) -> torch.Tensor:
        """Tile-and-blend decode for large images."""
        _, h, w, _ = latents.shape
        if h <= tile_latent_size and w <= tile_latent_size:
            return self.decode(latents)
        stride = int(tile_latent_size * (1 - overlap))
        r = self.compression_ratio
        rows = [[self.decode(latents[:, i:i + tile_latent_size,
                                     j:j + tile_latent_size])
                 for j in range(0, w, stride)] for i in range(0, h, stride)]
        blend_px = (tile_latent_size - stride) * r
        stride_px = stride * r

        def blend(a, b, extent, axis):
            b = b.clone()
            for y in range(extent):
                alpha = y / extent
                src = a.narrow(axis, a.shape[axis] - extent + y, 1)
                dst = b.narrow(axis, y, 1)
                dst.copy_(src * (1 - alpha) + dst * alpha)
            return b

        out_rows = []
        for i, row in enumerate(rows):
            blended = []
            for j, tile in enumerate(row):
                if i > 0:
                    tile = blend(rows[i - 1][j], tile, blend_px, 1)
                if j > 0:
                    tile = blend(row[j - 1], tile, blend_px, 2)
                blended.append(tile[:, :stride_px, :stride_px])
            out_rows.append(torch.cat(blended, dim=2))
        return torch.cat(out_rows, dim=1)[:, : h * r, : w * r]
