"""Text-to-image aspect-ratio-bucket dataset (port of
``vision_pt_tpu/data/text_to_image.py``).

The folder walk pairs images with ``.txt`` captions or ``.json`` metadata;
image sizes come from the headers; each image goes to its nearest bucket;
an item is decoded, cover-resized (bicubic) and randomly cropped, with SDXL's
size conditioning (``original_size``, ``target_size``,
``crop_coords_top_left``). Batches are NHWC float32 in [-1, 1], one shape per
bucket. Every draw comes from a generator of (seed, epoch, index), so the
same folder and seed give the JAX package's batches. The image-size cache is
JSONL or parquet.

Images decode through PIL. The JAX package's C decoder
(``native/image_loader.cpp``) is not ported (ROADMAP Queue 1 item 6):
``use_native_loader`` is accepted and every image takes the PIL path, which
is the JAX package's own path where its decoder is absent.
"""

from __future__ import annotations

import json
import os
import warnings
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator

import numpy as np
from PIL import Image
from pydantic import BaseModel

from .aspect_ratio_bucket import (
    AspectRatioBucketConfig,
    AspectRatioBucketManager,
    print_arb_info,
)
from .bucket import Bucket, ConcatBucketDataset
from .caption import CaptionProcessorList, apply_caption_processors
from .tags import format_general_character_tags, map_replace_underscore
from .transforms import ObjectCoverResize, random_crop, to_array


class ImageCaptionPair(BaseModel):
    """One image and its caption or metadata file."""

    image: Path
    width: int
    height: int
    caption: Path | None = None
    metadata: Path | None = None

    def read_caption(self, rng: np.random.Generator | None = None) -> str:
        if self.metadata is not None:
            with open(self.metadata) as f:
                metadata = json.load(f)
            if "tag_string" in metadata:
                return format_general_character_tags(
                    general=map_replace_underscore(
                        metadata.get("tag_string_general", "").split(" ")),
                    character=map_replace_underscore(
                        metadata.get("tag_string_copyright", "").split(" ")
                        + metadata.get("tag_string_character", "").split(" ")),
                    rating=metadata.get("rating", "general"),
                    separator=", ", group_separator="|||",
                )
            if "tagger" in metadata:  # wd-tagger-rs format
                return format_general_character_tags(
                    general=metadata["tagger"].get("general", []),
                    character=metadata["tagger"].get("character", []),
                    rating=metadata.get("rating", "general"),
                    separator=", ", group_separator="|||",
                )
            if "tags" in metadata:
                return metadata["tags"]
            if "caption" in metadata:
                return metadata["caption"]
            if "captions" in metadata:
                captions = metadata["captions"]
                r = rng if rng is not None else np.random.default_rng()
                return captions[int(r.integers(len(captions)))]
            raise ValueError(f"Caption not found in metadata {self.metadata}. "
                             f"Available keys: {', '.join(metadata.keys())}")
        if self.caption is None:
            raise ValueError(f"{self.image} has neither caption nor metadata")
        return self.caption.read_text()

    @property
    def should_skip(self) -> bool:
        if self.metadata is None:
            return False
        with open(self.metadata) as f:
            return bool(json.load(f).get("skip", False))


def probe_image_size(path: Path) -> tuple[int, int]:
    """(width, height) from the image header, without decoding pixels."""
    with Image.open(path) as img:
        return img.size


class TextToImageBucket(Bucket):
    """One resolution: cover-resize, random crop, size conditioning."""

    def __init__(self, items: list[dict], batch_size: int, width: int,
                 height: int, do_upscale: bool, num_repeats: int = 1,
                 caption_processors: CaptionProcessorList = [], seed: int = 0):
        super().__init__(items, batch_size, num_repeats)
        self.width = int(width)
        self.height = int(height)
        self.do_upscale = do_upscale
        self.caption_processors = caption_processors
        self.resize = ObjectCoverResize(self.width, self.height, do_upscale)
        self.seed = seed

    def load_item(self, idx: int) -> dict:
        item = self.get_item(idx)
        rng = self.item_rng(idx, self.seed)
        with Image.open(item["image"]) as pil:
            arr = to_array(self.resize(pil))
        orig_h, orig_w = arr.shape[:2]
        crop, (top, left) = random_crop(arr, self.height, self.width, rng)
        caption = apply_caption_processors(item["caption"],
                                           self.caption_processors, rng)
        return {
            "image": crop.astype(np.float32),
            "caption": caption,
            "original_size": np.asarray([orig_h, orig_w], dtype=np.int32),
            "target_size": np.asarray([self.height, self.width], dtype=np.int32),
            "crop_coords_top_left": np.asarray([top, left], dtype=np.int32),
        }


class TextToImageDatasetConfig(AspectRatioBucketConfig):
    supported_extensions: list[str] = [".png", ".jpg", ".jpeg", ".webp", ".avif"]
    caption_extension: str = ".txt"
    metadata_extension: str = ".json"
    has_skip_metadata: bool = False

    folder: str

    do_upscale: bool = False
    num_repeats: int = 1
    caption_processors: CaptionProcessorList = []
    imagesize_cache_path: str | None = None
    seed: int = 0
    use_native_loader: bool = True  # accepted; images decode through PIL

    # -------------------------------------------------- imagesize cache

    def _has_imagesize_cache(self) -> bool:
        p = self.imagesize_cache_path
        return p is not None and Path(p).exists() and Path(p).stat().st_size > 0

    def _load_imagesize_cache(self) -> Iterator[ImageCaptionPair]:
        path = Path(self.imagesize_cache_path)
        if path.suffix == ".parquet":
            import pyarrow.parquet as pq

            rows = (row for batch in pq.ParquetFile(str(path)).iter_batches()
                    for row in batch.to_pylist())
        else:
            with open(path) as f:
                rows = [json.loads(line) for line in f]
        for row in rows:
            yield ImageCaptionPair(
                image=Path(row["image"]), width=row["width"], height=row["height"],
                caption=Path(row["caption"]) if row.get("caption") else None,
                metadata=Path(row["metadata"]) if row.get("metadata") else None,
            )

    def _save_imagesize_cache(self, pairs: list[ImageCaptionPair]) -> None:
        path = Path(self.imagesize_cache_path)
        if path.suffix not in (".jsonl", ".parquet"):
            raise ValueError("imagesize cache must be .jsonl or .parquet")
        path.parent.mkdir(parents=True, exist_ok=True)
        rows = [{"image": str(p.image), "width": p.width, "height": p.height,
                 "caption": str(p.caption) if p.caption else None,
                 "metadata": str(p.metadata) if p.metadata else None}
                for p in pairs]
        if path.suffix == ".parquet":
            import pyarrow as pa
            import pyarrow.parquet as pq

            pq.write_table(pa.Table.from_pylist(rows), str(path))
            return
        with open(path, "w") as f:
            for row in rows:
                f.write(json.dumps(row, ensure_ascii=False) + "\n")

    # -------------------------------------------------- folder walk

    def _yield_tasks(self) -> Iterator[tuple]:
        """(image, caption or None, metadata or None), images without
        either left out."""
        for root, _, files in os.walk(self.folder):
            files_set = set(files)
            root_path = Path(root)
            for file_name in sorted(files):
                if not any(file_name.endswith(ext) for ext in self.supported_extensions):
                    continue
                stem = (root_path / file_name).stem
                caption = stem + self.caption_extension
                metadata = stem + self.metadata_extension
                caption_path = root_path / caption if caption in files_set else None
                metadata_path = root_path / metadata if metadata in files_set else None
                if caption_path is None and metadata_path is None:
                    continue
                yield root_path / file_name, caption_path, metadata_path

    def _process_single_entry(self, entry) -> ImageCaptionPair | None:
        image_path, caption_path, metadata_path = entry
        try:
            width, height = probe_image_size(image_path)
        except (OSError, ValueError):
            return None
        pair = ImageCaptionPair(image=image_path, width=width, height=height,
                                caption=caption_path, metadata=metadata_path)
        if self.has_skip_metadata and pair.should_skip:
            return None
        return pair

    def _retrieve_images(self) -> Iterator[ImageCaptionPair]:
        tasks = list(self._yield_tasks())
        with ThreadPoolExecutor(max_workers=self.num_workers) as executor:
            for pair in executor.map(self._process_single_entry, tasks, chunksize=64):
                if pair is not None:
                    yield pair

    # -------------------------------------------------- buckets

    def generate_buckets(self) -> list[TextToImageBucket]:
        arb = AspectRatioBucketManager(self.buckets)
        rng = np.random.default_rng(self.seed)
        pairs_iter = (self._load_imagesize_cache() if self._has_imagesize_cache()
                      else self._retrieve_images())
        bucket_subsets: dict[int, list[ImageCaptionPair]] = defaultdict(list)
        for pair in pairs_iter:
            try:
                idx = arb.find_nearest(pair.width, pair.height)
            except ValueError as e:
                warnings.warn(f"Image size {pair.width}x{pair.height} fits no "
                              f"bucket and do_upscale is False. Skipping. {e}",
                              UserWarning)
                continue
            bucket_subsets[idx].append(pair)

        if self.imagesize_cache_path is not None and not self._has_imagesize_cache():
            self._save_imagesize_cache(
                [p for pairs in bucket_subsets.values() for p in pairs])

        buckets = []
        for idx, pairs in bucket_subsets.items():
            width, height = self.buckets[idx]
            items = [{"image": str(p.image), "caption": p.read_caption(rng)}
                     for p in pairs]
            bucket = TextToImageBucket(
                items=items, batch_size=self.batch_size, width=width,
                height=height, do_upscale=self.do_upscale,
                num_repeats=self.num_repeats,
                caption_processors=self.caption_processors, seed=self.seed)
            bucket.load_workers = max(1, self.num_workers)
            buckets.append(bucket)
        return buckets

    def get_dataset(self) -> ConcatBucketDataset:
        buckets = self.generate_buckets()
        print_arb_info(buckets)
        return ConcatBucketDataset(buckets, shuffle=self.shuffle, seed=self.seed)
