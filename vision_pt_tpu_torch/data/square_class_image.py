"""Square class-image datasets (the port's own copy of
``vision_pt_tpu/data/square_class_image.py``).

``SquareClassImageDatasetConfig`` reads images paired with tag JSONs in a
separate folder (rating, character and general tags, shuffled into a
caption), resizes the short side, center-crops the square and scales to
[-1, 1]. ``SyntheticClassImageDatasetConfig`` makes deterministic
class-coloured gradient images instead. Both give NHWC float32 arrays, the
same as the JAX package's for the same seed.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
from PIL import Image
from pydantic import BaseModel

from .bucket import Bucket, ConcatBucketDataset
from .caption import CaptionProcessorList, apply_caption_processors
from .transforms import center_crop, resize_max_side, to_array

SUPPORTED_EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp", ".avif", ".bmp")


class SquareClassImageBucket(Bucket):
    """Decode -> resize the short side -> center crop the square ->
    normalise; captions through the processors with a per-item generator."""

    def __init__(self, items, batch_size: int, image_size: int,
                 num_repeats: int = 1, caption_processors: list | None = None,
                 seed: int = 0):
        super().__init__(items, batch_size, num_repeats)
        self.image_size = image_size
        self.caption_processors = caption_processors or []
        self.seed = seed

    def load_item(self, idx: int) -> dict:
        item = self.get_item(idx)
        rng = self.item_rng(idx, self.seed)
        with Image.open(item["image"]) as img:
            arr = to_array(resize_max_side(img, self.image_size))
        arr = center_crop(arr, self.image_size, self.image_size)
        caption = apply_caption_processors(item["caption"],
                                           self.caption_processors, rng)
        return {"image": arr.astype(np.float32), "caption": caption}


def read_tag_caption(metadata_path: Path, rng: np.random.Generator) -> str:
    """rating + character + general tags, shuffled."""
    with open(metadata_path) as f:
        metadata = json.load(f)
    rating = metadata.get("rating", "general")
    character = list(metadata.get("character_tags", {}).keys())
    general = list(metadata.get("general_tags", {}).keys())
    tags = [rating, *character, *general]
    rng.shuffle(tags)
    return " ".join(tags)


class SquareClassImageDatasetConfig(BaseModel):
    folder: str
    tags_folder: str
    image_size: int = 256
    batch_size: int = 16
    num_repeats: int = 1
    metadata_extension: str = ".json"
    caption_processors: CaptionProcessorList = []
    shuffle: bool = True
    seed: int = 0

    def _retrieve_items(self) -> list[dict]:
        rng = np.random.default_rng(self.seed)
        items = []
        tags_folder = Path(self.tags_folder)
        for root, _, files in os.walk(self.folder):
            for file in sorted(files):
                if not file.lower().endswith(SUPPORTED_EXTENSIONS):
                    continue
                metadata_path = (tags_folder / file).with_suffix(
                    self.metadata_extension
                )
                if not metadata_path.exists():
                    continue
                items.append({
                    "image": str(Path(root) / file),
                    "caption": read_tag_caption(metadata_path, rng),
                })
        return items

    def get_dataset(self) -> ConcatBucketDataset:
        bucket = SquareClassImageBucket(
            items=self._retrieve_items(), batch_size=self.batch_size,
            image_size=self.image_size, num_repeats=self.num_repeats,
            caption_processors=self.caption_processors, seed=self.seed,
        )
        return ConcatBucketDataset([bucket], shuffle=self.shuffle, seed=self.seed)


class _SyntheticClassBucket(Bucket):
    """Each class has a fixed colour signature plus structured noise, so a
    model can learn the mapping."""

    def __init__(self, num_classes: int, num_items: int, image_size: int,
                 batch_size: int, seed: int = 0):
        super().__init__(list(range(num_items)), batch_size, num_repeats=1)
        self.num_classes = num_classes
        self.image_size = image_size
        self.seed = seed

    def load_item(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        cls = idx % self.num_classes
        size = self.image_size
        # class-specific base colour in [-1, 1]
        base_rng = np.random.default_rng(cls)
        base = base_rng.uniform(-0.8, 0.8, size=(3,)).astype(np.float32)
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)
        gradient = (yy[..., None] - 0.5) * base[None, None] * 0.5
        img = base[None, None, :] + gradient
        img += rng.normal(scale=0.05, size=(size, size, 3)).astype(np.float32)
        return {
            "image": np.clip(img, -1, 1).astype(np.float32),
            "caption": f"c{cls}",
        }


class SyntheticClassImageDatasetConfig(BaseModel):
    """A dataset with no files: ``num_items`` images of ``num_classes``
    classes, captioned ``c0``, ``c1``, ..."""

    num_classes: int = 4
    num_items: int = 64
    image_size: int = 64
    batch_size: int = 16
    shuffle: bool = True
    seed: int = 0

    def get_dataset(self) -> ConcatBucketDataset:
        bucket = _SyntheticClassBucket(
            num_classes=self.num_classes, num_items=self.num_items,
            image_size=self.image_size, batch_size=self.batch_size,
            seed=self.seed,
        )
        return ConcatBucketDataset([bucket], shuffle=self.shuffle, seed=self.seed)

    def label2id(self) -> dict[str, int]:
        return {f"c{i}": i for i in range(self.num_classes)}
