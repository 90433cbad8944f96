"""Offline VAE-latent caching and the cached-latent dataset (port of
``vision_pt_tpu/data/latent_cache.py``).

Cache layout under ``cache_dir``, the JAX package's:
- ``manifest.jsonl``: one row per item: latent file, latent shape, caption,
  SDXL size conditioning, the VAE scaling factor used, the stored dtype;
- ``<sha1>.npz``: ``mean``/``std`` of the latent distribution (fp16, or
  bfloat16 stored as raw uint16 bits with a ``dtype`` row tag).

:func:`cache_latents` writes it with one batched VAE encode per batch of the
text-to-image bucket dataset, naming each file by the hash the JAX package
computes, so either package reads the other's cache. Training draws
``mean + std * eps`` with the bucket's per-(seed, epoch, index) generator,
exactly as the JAX package does, so both packages give the same arrays from
the same cache. Latents are NHWC.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch
from pydantic import BaseModel

from .bucket import Bucket, ConcatBucketDataset
from .caption import CaptionProcessorList, apply_caption_processors

MANIFEST_NAME = "manifest.jsonl"
_STORED = {torch.float16: "float16", torch.bfloat16: "bfloat16"}


def _stored_array(x: torch.Tensor, dtype: torch.dtype) -> np.ndarray:
    """fp16 as is; bfloat16 as its raw bits in uint16 (npz cannot hold it)."""
    x = x.to(dtype).cpu()
    if dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


@torch.no_grad()
def cache_latents(dataset: ConcatBucketDataset, vae, cache_dir: str,
                  dtype: torch.dtype = torch.float16, progress: bool = True) -> str:
    """The batched VAE encode pass: each batch of ``dataset`` (``image``
    NHWC in [-1, 1], caption and size fields: the text-to-image layout) is
    encoded on the VAE's device in fp32 inputs, and its mean and
    ``exp(0.5 clip(logvar, -30, 20))`` written item by item in ``dtype``
    (fp16 or bf16). Returns the manifest path."""
    if dtype not in _STORED:
        raise ValueError(f"latent cache dtype must be float16 or bfloat16, not {dtype}")
    device = next(vae.parameters()).device
    out_dir = Path(cache_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    manifest_path = out_dir / MANIFEST_NAME
    n_items = 0
    with open(manifest_path, "w") as mf:
        for batch in dataset:
            images = batch["image"]
            if images.ndim == 4 and images.shape[-1] != 3 and images.shape[1] == 3:
                images = np.moveaxis(images, 1, -1)
            dist = vae.encode(torch.as_tensor(np.ascontiguousarray(images)).to(
                device, torch.float32))
            std = torch.exp(0.5 * torch.clamp(dist.logvar, -30.0, 20.0))
            mean, std = _stored_array(dist.mean, dtype), _stored_array(std, dtype)
            for i in range(mean.shape[0]):
                row = {
                    "caption": batch["caption"][i],
                    "height": int(images.shape[1]),
                    "width": int(images.shape[2]),
                    "original_size": np.asarray(batch["original_size"][i]).tolist(),
                    "target_size": np.asarray(batch["target_size"][i]).tolist(),
                    "crop_coords_top_left": np.asarray(
                        batch["crop_coords_top_left"][i]).tolist(),
                    "scaling_factor": float(vae.scaling_factor),
                    "dtype": _STORED[dtype],
                }
                key = hashlib.sha1(json.dumps(row, sort_keys=True).encode()
                                   + mean[i].tobytes()[:256]).hexdigest()
                fname = f"{key}.npz"
                np.savez(out_dir / fname, mean=mean[i], std=std[i])
                row["file"] = fname
                row["latent_height"] = int(mean.shape[1])
                row["latent_width"] = int(mean.shape[2])
                mf.write(json.dumps(row) + "\n")
                n_items += 1
    if progress:
        print(f"[latent_cache] wrote {n_items} latents to {out_dir}")
    return str(manifest_path)


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
