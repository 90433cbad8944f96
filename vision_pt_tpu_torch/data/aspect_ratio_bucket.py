"""Aspect-ratio bucketing (the port's own copy of
``vision_pt_tpu/data/aspect_ratio_bucket.py``).

Buckets walk the width down from the base size, round the paired height to
the step and take both orientations. An image goes to the bucket of the
closest log2 aspect ratio among those that fit inside it (no upscaling),
ties to the higher resolution. Each bucket yields batches of one shape.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
from pydantic import BaseModel

from .bucket import Bucket


def generate_buckets(target_area: int = 1024 * 1024, start_size: int = 1024,
                     step: int = 64, min_size: int = 64) -> np.ndarray:
    """(w, h) pairs near ``target_area`` at ``step`` granularity, with
    their transposes."""
    buckets: list[np.ndarray] = []
    w = start_size
    while w >= min_size:
        h = round((target_area / w) / step) * step
        if h < min_size:
            break
        buckets.append(np.array([w, h]))
        if w != h:
            buckets.append(np.array([h, w]))
        w -= step
    return np.stack(buckets)


class AspectRatioBucketManager:
    """Assigns image sizes to buckets."""

    def __init__(self, buckets: np.ndarray):
        self.buckets = buckets
        self.aspect_ratios = np.log2(buckets[:, 0] / buckets[:, 1])
        self.resolutions = buckets[:, 0] * buckets[:, 1]
        self.sorted_indices = np.argsort(-self.resolutions)

    def __len__(self) -> int:
        return self.buckets.shape[0]

    def __iter__(self):
        for bucket in self.buckets:
            yield bucket[0], bucket[1]

    @staticmethod
    def aspect_ratio(width: int, height: int) -> float:
        return math.log2(width / height)

    def find_nearest(self, width: int, height: int) -> int:
        """The closest-log-aspect bucket that fits inside (width, height):
        scanned by descending resolution, the first strict minimum wins."""
        fits = (self.buckets[:, 0] <= width) & (self.buckets[:, 1] <= height)
        if not fits.any():
            raise ValueError(f"No bucket found for image size {width}x{height}")
        diffs = np.abs(self.aspect_ratios - self.aspect_ratio(width, height))
        best_idx, best = None, np.inf
        for idx in self.sorted_indices:
            if fits[idx] and diffs[idx] < best:
                best, best_idx = diffs[idx], idx
        return int(best_idx)

    def find_nearest_batch(self, widths: np.ndarray, heights: np.ndarray) -> np.ndarray:
        """:meth:`find_nearest` over whole arrays of sizes."""
        widths = np.asarray(widths)[:, None]
        heights = np.asarray(heights)[:, None]
        fits = ((self.buckets[None, :, 0] <= widths)
                & (self.buckets[None, :, 1] <= heights))
        diffs = np.abs(self.aspect_ratios[None, :] - np.log2(widths / heights))
        # ties go to the higher resolution: a tiny penalty by resolution rank
        rank = np.empty(len(self.buckets))
        rank[self.sorted_indices] = np.arange(len(self.buckets))
        penalized = np.where(fits, diffs + rank[None, :] * 1e-12, np.inf)
        if (~fits.any(axis=1)).any():
            bad = np.where(~fits.any(axis=1))[0]
            raise ValueError(
                f"{len(bad)} images fit no bucket (first: "
                f"{int(widths[bad[0], 0])}x{int(heights[bad[0], 0])})")
        return np.argmin(penalized, axis=1)


class AspectRatioBucketConfig(BaseModel):
    batch_size: int = 32
    shuffle: bool = True
    num_workers: int = 8

    bucket_base_size: int = 1024
    step: int = 64
    min_size: int = 384

    @property
    def buckets(self) -> np.ndarray:
        return generate_buckets(target_area=self.bucket_base_size**2,
                                start_size=self.bucket_base_size,
                                step=self.step, min_size=self.min_size)


def print_arb_info(buckets: Sequence[Bucket], print_fn=print):
    print_fn("===== Bucket info =====")
    print_fn(f"=== Number of buckets: {len(buckets)}")
    for idx, bucket in enumerate(buckets):
        print_fn(f"Bucket {idx:>3} | {bucket.width:>6,}x{bucket.height:<6,} | "
                 f"{bucket.num_items:>8,} images |")
    print_fn("===== End of Bucket info =====")
