"""Patchify / unpatchify on NHWC images (port of
``vision_pt_tpu/ops/patch.py``). Per-patch features are ordered
(c, ph, pw), as in the JAX package and the reference's NCHW code."""

from __future__ import annotations

from typing import NamedTuple

import torch


class PatchifyOutput(NamedTuple):
    patches: torch.Tensor  # (B, num_patches, patch*patch*C)
    grid_height: int
    grid_width: int


def patchify(image: torch.Tensor, patch_size: int) -> PatchifyOutput:
    """(B, H, W, C) -> (B, gh*gw, C*P*P), features ordered (c, ph, pw)."""
    if image.dim() == 3:
        image = image[None]
    batch, height, width, channels = image.shape
    gh, gw = height // patch_size, width // patch_size
    x = image.reshape(batch, gh, patch_size, gw, patch_size, channels)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, gh, gw, C, ph, pw)
    patches = x.reshape(batch, gh * gw, channels * patch_size * patch_size)
    return PatchifyOutput(patches=patches, grid_height=gh, grid_width=gw)


def unpatchify(patches: torch.Tensor, grid_height: int, grid_width: int,
               patch_size: int, out_channels: int) -> torch.Tensor:
    """Inverse of :func:`patchify`; returns an NHWC image."""
    if patches.dim() == 2:
        patches = patches[None]
    batch = patches.shape[0]
    x = patches.reshape(batch, grid_height, grid_width, out_channels,
                        patch_size, patch_size)
    x = x.permute(0, 1, 4, 2, 5, 3)  # (B, gh, ph, gw, pw, C)
    return x.reshape(batch, grid_height * patch_size,
                     grid_width * patch_size, out_channels)


def pixel_shuffle_nhwc(x: torch.Tensor, upscale: int) -> torch.Tensor:
    """(B, H, W, C*r^2) -> (B, H*r, W*r, C); channel c*r*r + i*r + j goes to
    channel c at offset (i, j), as ``F.pixel_shuffle`` does on NCHW."""
    batch, height, width, channels = x.shape
    out_c = channels // (upscale * upscale)
    x = x.reshape(batch, height, width, out_c, upscale, upscale)
    x = x.permute(0, 1, 4, 2, 5, 3)  # (B, H, r, W, r, C)
    return x.reshape(batch, height * upscale, width * upscale, out_c)
