"""Tensor <-> PIL utilities (port of ``vision_pt_tpu/utils/tensor.py``).

Images are NHWC float in [-1, 1], as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image


def incremental_seed_randn(
    shape: tuple[int, ...],
    seed: int | None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """Per-sample seeded noise: sample b draws from a generator seeded with
    seed + b, so a batch reproduces the images of single generations. The
    numbers are torch's, not ``jax.random``'s: tests inject noise instead."""
    if seed is None:
        seed = int(np.random.default_rng().integers(0, 2**31 - 1))
    device = torch.device(device)
    samples = []
    for b in range(shape[0]):
        gen = torch.Generator(device=device).manual_seed(seed + b)
        samples.append(torch.randn(shape[1:], generator=gen, device=device))
    return torch.stack(samples).to(dtype)


def tensor_to_images(tensor: torch.Tensor) -> list[Image.Image]:
    """NHWC float in [-1, 1] -> list of PIL images."""
    arr = tensor.detach().float().cpu().numpy()
    arr = np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return [Image.fromarray(a) for a in arr]


def images_to_tensor(images: list[Image.Image]) -> torch.Tensor:
    """PIL RGB -> NHWC float32 in [-1, 1] (on the CPU)."""
    arrs = [np.asarray(img.convert("RGB"), dtype=np.float32) / 127.5 - 1.0
            for img in images]
    return torch.from_numpy(np.stack(arrs))
