"""Resize JiT patch-embed / final-layer weights to a new patch size (port
of ``tools/model/expand_patch_embed.py``).

Works on torch-layout safetensors checkpoints: the conv weight (Out, In, H,
W), the final linear (P*P*C, hidden) flattened in (ph, pw, c) order, as
JiT's unpatchify reads it.

    python -m vision_pt_tpu_torch.tools.model.expand_patch_embed \\
        -i jit.safetensors -o jit32.safetensors -p 32 -m bicubic

The JAX tool resizes with ``jax.image.resize``, whose kernels are
antialiased when shrinking and whose cubic is Keys' a = -0.5: that is
``F.interpolate``'s ``bicubic`` and ``bilinear`` with ``antialias=True``
(its plain bicubic is a = -0.75), and its ``nearest`` takes half-pixel
centres, ``nearest-exact``.
"""

from __future__ import annotations

import click
import numpy as np
import torch
import torch.nn.functional as F

EMBED_WEIGHT_KEY = "denoiser.patch_embedder.proj_1.weight"
FINAL_WEIGHT_KEY = "denoiser.final_layer.linear.weight"
FINAL_BIAS_KEY = "denoiser.final_layer.linear.bias"

_MODES = {"bicubic": dict(mode="bicubic", antialias=True),
          "bilinear": dict(mode="bilinear", antialias=True),
          "nearest": dict(mode="nearest-exact")}


def _resize_hw(arr: np.ndarray, size: tuple[int, int], mode: str) -> np.ndarray:
    """Resize the last two axes of a 4-D array to ``size``."""
    x = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return F.interpolate(x, size=size, **_MODES[mode]).numpy()


def resize_patch_embed_weight(weight: np.ndarray, target_size, mode="bicubic"):
    """(Out, In, H, W) conv filter resize, rescaled by the area ratio so the
    response keeps its energy."""
    new = _resize_hw(weight, target_size, mode)
    return new * (target_size[0] * target_size[1]) / (
        weight.shape[2] * weight.shape[3]
    )


def resize_final_layer_weight(weight: np.ndarray, old_patch_size: int,
                              target_size, mode="bicubic", out_channels=3):
    """(P*P*C, hidden) -> (P, P, C, hidden), spatial axes resized."""
    out_dim, hidden = weight.shape
    spatial = weight.reshape(old_patch_size, old_patch_size, out_channels,
                             hidden)
    permuted = spatial.transpose(3, 2, 0, 1)  # (hidden, C, H, W)
    resized = _resize_hw(permuted, target_size, mode)
    return resized.transpose(2, 3, 1, 0).reshape(-1, hidden)


def resize_final_layer_bias(bias: np.ndarray, old_patch_size: int,
                            target_size, mode="bicubic", out_channels=3):
    spatial = bias.reshape(1, old_patch_size, old_patch_size,
                           out_channels).transpose(0, 3, 1, 2)
    resized = _resize_hw(spatial, target_size, mode)
    return resized.transpose(0, 2, 3, 1).reshape(-1)


@click.command()
@click.option("--input", "-i", "input_path", type=str, required=True)
@click.option("--output", "-o", "output_path", type=str, required=True)
@click.option("--patch_size", "-p", type=int, default=32)
@click.option("--mode", "-m",
              type=click.Choice(["bicubic", "bilinear", "nearest"]),
              default="bicubic")
def main(input_path: str, output_path: str, patch_size: int, mode: str):
    from safetensors.numpy import load_file, save_file

    state_dict = dict(load_file(input_path))
    target_size = (patch_size, patch_size)

    embed_weight = state_dict[EMBED_WEIGHT_KEY]
    old_patch_size = embed_weight.shape[2]
    print(f"Resizing '{EMBED_WEIGHT_KEY}': {old_patch_size} -> {patch_size}")
    state_dict[EMBED_WEIGHT_KEY] = resize_patch_embed_weight(
        embed_weight, target_size, mode
    )
    print(f"Resizing '{FINAL_WEIGHT_KEY}'")
    state_dict[FINAL_WEIGHT_KEY] = resize_final_layer_weight(
        state_dict[FINAL_WEIGHT_KEY], old_patch_size, target_size, mode
    )
    state_dict[FINAL_BIAS_KEY] = resize_final_layer_bias(
        state_dict[FINAL_BIAS_KEY], old_patch_size, target_size, mode
    )
    save_file({k: np.ascontiguousarray(v) for k, v in state_dict.items()}, output_path)
    print(f"Saved expanded patch embedding to '{output_path}'.")


if __name__ == "__main__":
    main()
