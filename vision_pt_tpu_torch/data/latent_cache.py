"""The cached-latent dataset (the port's own copy of
``vision_pt_tpu/data/latent_cache.py``).

Reads the JAX package's cache layout under ``cache_dir``:
- ``manifest.jsonl``: one row per item: latent file, latent shape, caption,
  SDXL size conditioning, the VAE scaling factor used, the stored dtype;
- ``<sha1>.npz``: ``mean``/``std`` of the latent distribution (fp16, or
  bfloat16 stored as raw uint16 bits with a ``dtype`` row tag).

Training draws ``mean + std * eps`` with the bucket's per-(seed, epoch, index)
generator, exactly as the JAX package does, so both packages give the same
arrays from the same cache. Latents are NHWC. Writing a cache runs the SDXL
VAE (``models.sdxl.vae``) over the text-to-image bucket dataset
(``data.text_to_image``); that writer is not ported yet:
:func:`cache_latents` raises.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from pydantic import BaseModel

from .bucket import Bucket, ConcatBucketDataset
from .caption import CaptionProcessorList, apply_caption_processors

MANIFEST_NAME = "manifest.jsonl"


def cache_latents(*args, **kwargs) -> str:
    """The batched VAE encode pass that writes a cache; it iterates the
    text-to-image bucket dataset."""
    raise NotImplementedError(
        "cache_latents (the VAE encode pass over the text-to-image dataset) "
        "is not ported yet: ROADMAP Queue 1 item 3, a leftover of the SDXL "
        "training slice (slice 5 of the first plan); build the cache with the "
        "JAX package's tools/data/cache_latents.py"
    )


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """Raw bfloat16 bits (uint16) -> float32, exactly."""
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).float().numpy()


class CachedLatentBucket(Bucket):
    """Serves pre-encoded latents. Batch fields: ``latents`` (scaled,
    sampled), caption and the SDXL size conditioning."""

    def __init__(self, rows: list[dict], cache_dir: str, batch_size: int,
                 num_repeats: int = 1, sample: bool = True, seed: int = 0,
                 caption_processors: CaptionProcessorList = ()):
        super().__init__(rows, batch_size, num_repeats)
        self.cache_dir = Path(cache_dir)
        self.sample = sample
        self.seed = seed
        self.caption_processors = list(caption_processors)

    def load_item(self, idx: int) -> dict:
        row = self.get_item(idx)
        rng = self.item_rng(idx, self.seed)
        with np.load(self.cache_dir / row["file"]) as z:
            mean, std = z["mean"], z["std"]
        if row.get("dtype") == "bfloat16":  # stored as raw uint16 bits
            mean, std = _bf16_bits_to_f32(mean), _bf16_bits_to_f32(std)
        mean = mean.astype(np.float32)
        std = std.astype(np.float32)
        if self.sample:
            latent = mean + std * rng.standard_normal(mean.shape).astype(np.float32)
        else:
            latent = mean
        latent = latent * row.get("scaling_factor", 1.0)
        caption = apply_caption_processors(row["caption"], self.caption_processors,
                                           rng)
        return {
            "latents": latent,
            "caption": caption,
            "original_size": np.asarray(row["original_size"], dtype=np.int32),
            "target_size": np.asarray(row["target_size"], dtype=np.int32),
            "crop_coords_top_left": np.asarray(row["crop_coords_top_left"],
                                               dtype=np.int32),
        }


class CachedLatentDatasetConfig(BaseModel):
    """Dataset mode over a latent cache directory. Buckets form by latent
    shape, so every batch has one shape."""

    cache_dir: str
    batch_size: int = 32
    num_repeats: int = 1
    shuffle: bool = True
    num_workers: int = 8
    sample_latents: bool = True  # draw mean + std*eps per epoch vs mean only
    caption_processors: CaptionProcessorList = []
    seed: int = 0

    def get_dataset(self) -> ConcatBucketDataset:
        rows_by_shape: dict[tuple[int, int], list[dict]] = {}
        with open(Path(self.cache_dir) / MANIFEST_NAME) as f:
            for line in f:
                row = json.loads(line)
                shape = (row["latent_height"], row["latent_width"])
                rows_by_shape.setdefault(shape, []).append(row)
        buckets = []
        for shape in sorted(rows_by_shape):
            bucket = CachedLatentBucket(
                rows_by_shape[shape], cache_dir=self.cache_dir,
                batch_size=self.batch_size, num_repeats=self.num_repeats,
                sample=self.sample_latents, seed=self.seed,
                caption_processors=self.caption_processors,
            )
            bucket.load_workers = max(1, self.num_workers)
            buckets.append(bucket)
        if not buckets:
            raise ValueError(f"empty latent cache at {self.cache_dir}")
        return ConcatBucketDataset(buckets, shuffle=self.shuffle, seed=self.seed)
