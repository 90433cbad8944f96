"""Referenced text-to-image dataset (port of
``vision_pt_tpu/data/referenced_text_to_image.py``).

Each sample carries a reference image, letterboxed to a square in [-1, 1],
for IP-Adapter and PFG training; its caption is composed from the metadata
JSON's tag groups, each group shuffled. The same folder and seed give the
JAX package's batches.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Iterator

import numpy as np
from PIL import Image

from .aspect_ratio_bucket import AspectRatioBucketManager, print_arb_info
from .bucket import ConcatBucketDataset
from .text_to_image import (
    ImageCaptionPair,
    TextToImageBucket,
    TextToImageDatasetConfig,
    probe_image_size,
)
from .transforms import PaddedResize, to_array


def compose_caption(copyright: list[str], character: list[str], general: list[str],
                    meta: list[str], people: list[str],
                    rng: np.random.Generator | None = None) -> str:
    """people, character, copyright, then general + meta, each group
    shuffled."""
    r = rng if rng is not None else np.random.default_rng()

    def shuffled(items: list[str]) -> list[str]:
        items = list(items)
        r.shuffle(items)
        return items

    return ", ".join([*shuffled(people), *shuffled(character), *shuffled(copyright),
                      *shuffled(general + meta)])


class ImageCaptionPairWithReference(ImageCaptionPair):
    reference_image: Path
    copyright: list[str] = []
    character: list[str] = []
    general: list[str] = []
    meta: list[str] = []
    people: list[str] = []


class ReferencedTextToImageBucket(TextToImageBucket):
    """A text-to-image bucket whose items also carry ``reference_image``."""

    def __init__(self, reference_size: int, background_color: int = 0, **kw):
        super().__init__(**kw)
        self.reference_resize = PaddedResize(max_size=reference_size, fill=background_color)

    def load_item(self, idx: int) -> dict:
        out = super().load_item(idx)
        with Image.open(self.get_item(idx)["reference_image"]) as ref:
            padded = self.reference_resize(ref.convert("RGB"))
        out["reference_image"] = to_array(padded).astype(np.float32)
        return out


class ReferencedTextToImageDatasetConfig(TextToImageDatasetConfig):
    """Images with metadata JSONs that carry the tag groups and the path of
    the reference image (``reference_key``); images without one are left
    out."""

    reference_size: int = 224
    background_color: int = 0
    reference_key: str = "reference_image"

    def _retrieve_pairs(self) -> Iterator[ImageCaptionPairWithReference]:
        for root, _, files in os.walk(self.folder):
            files_set = set(files)
            root_path = Path(root)
            for file_name in sorted(files):
                if not any(file_name.endswith(ext) for ext in self.supported_extensions):
                    continue
                image_path = root_path / file_name
                metadata_path = root_path / (image_path.stem + self.metadata_extension)
                if metadata_path.name not in files_set:
                    continue
                with open(metadata_path) as f:
                    metadata = json.load(f)
                ref = metadata.get(self.reference_key)
                if ref is None:
                    continue
                try:
                    width, height = probe_image_size(image_path)
                except (OSError, ValueError):
                    continue
                yield ImageCaptionPairWithReference(
                    image=image_path, width=width, height=height, metadata=metadata_path,
                    reference_image=Path(ref),
                    **{group: metadata.get(group, []) for group in
                       ("copyright", "character", "general", "meta", "people")})

    def generate_buckets(self) -> list[ReferencedTextToImageBucket]:
        arb = AspectRatioBucketManager(self.buckets)
        rng = np.random.default_rng(self.seed)
        subsets: dict[int, list[ImageCaptionPairWithReference]] = {}
        for pair in self._retrieve_pairs():
            try:
                idx = arb.find_nearest(pair.width, pair.height)
            except ValueError:
                continue
            subsets.setdefault(idx, []).append(pair)
        buckets = []
        for idx, pairs in subsets.items():
            width, height = self.buckets[idx]
            items = [{"image": str(p.image), "reference_image": str(p.reference_image),
                      "caption": compose_caption(p.copyright, p.character, p.general,
                                                 p.meta, p.people, rng)}
                     for p in pairs]
            buckets.append(ReferencedTextToImageBucket(
                reference_size=self.reference_size,
                background_color=self.background_color, items=items,
                batch_size=self.batch_size, width=width, height=height,
                do_upscale=self.do_upscale, num_repeats=self.num_repeats,
                caption_processors=self.caption_processors, seed=self.seed))
        return buckets

    def get_dataset(self) -> ConcatBucketDataset:
        buckets = self.generate_buckets()
        print_arb_info(buckets)
        return ConcatBucketDataset(buckets, shuffle=self.shuffle, seed=self.seed)
