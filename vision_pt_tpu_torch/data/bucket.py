"""Bucket core: fixed-shape batch containers (the port's own copy of
``vision_pt_tpu/data/bucket.py``).

A ``Bucket`` holds items of one resolution and serves whole batches, so every
batch from one bucket has one shape. ``BucketDataset`` indexes batches;
``ConcatBucketDataset`` interleaves buckets per epoch, in the same shuffled
order as the JAX package for the same seed. All NumPy; a background thread
(``prefetch_iterator``) overlaps decoding with the device.
"""

from __future__ import annotations

import math
import random
from typing import Any, Iterator, Sequence

import numpy as np


def bucketing_collate(items: list[dict]) -> dict[str, Any]:
    """Stack array fields, keep list fields."""
    out: dict[str, Any] = {}
    if not items:
        return out
    for key in items[0]:
        values = [item[key] for item in items]
        if isinstance(values[0], np.ndarray):
            out[key] = np.stack(values)
        else:
            out[key] = values
    return out


class Bucket:
    """Repeatable item container with modulo indexing."""

    def __init__(self, items: Sequence, batch_size: int, num_repeats: int = 1):
        self.items = items
        self.num_items = len(items)
        self.batch_size = batch_size
        self.num_repeats = num_repeats
        self.epoch = 0  # set by ConcatBucketDataset; feeds per-item RNGs

    def item_rng(self, idx: int, seed: int = 0) -> np.random.Generator:
        """Deterministic per-(seed, epoch, index) generator — thread-safe
        under the parallel batch loader (a shared Generator would race) and
        reproducible across resume."""
        return np.random.default_rng(
            np.random.SeedSequence((seed, self.epoch, idx))
        )

    def __len__(self) -> int:
        return self.num_items * self.num_repeats

    def get_item(self, idx: int):
        return self.items[idx % self.num_items]

    def load_item(self, idx: int) -> dict:
        """Subclasses decode/transform here; base returns the raw item."""
        item = self.get_item(idx)
        return item if isinstance(item, dict) else {"item": item}

    # decode workers per batch: PIL releases the GIL, so threads overlap
    # decoding with device compute even on few cores
    load_workers: int = 4

    def get_batch(self, batch_idx: int) -> dict[str, Any]:
        start = batch_idx * self.batch_size
        idxs = list(range(start, min(start + self.batch_size, len(self))))
        if self.load_workers > 1 and len(idxs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=self.load_workers) as pool:
                items = list(pool.map(self.load_item, idxs))
        else:
            items = [self.load_item(i) for i in idxs]
        return bucketing_collate(items)

    @property
    def num_batches(self) -> int:
        return math.ceil(len(self) / self.batch_size)


class BucketDataset:
    """Batch-level view of one bucket."""

    def __init__(self, bucket: Bucket):
        self.bucket = bucket

    def __len__(self) -> int:
        return self.bucket.num_batches

    def __getitem__(self, idx: int) -> dict[str, Any]:
        return self.bucket.get_batch(idx)


def prefetch_iterator(iterable: Iterator, depth: int = 2) -> Iterator:
    """Pull batches on a background thread so host-side decode overlaps
    device compute. Exceptions propagate to the consumer."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            q.put(("__error__", e))
        finally:
            q.put(_END)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] == "__error__":
            raise item[1]
        yield item


class ConcatBucketDataset:
    """Epoch iterator over several buckets with optional shuffling of the
    global batch order."""

    def __init__(
        self,
        buckets: list[Bucket],
        shuffle: bool = True,
        seed: int = 0,
        host_index: int = 0,
        host_count: int = 1,
    ):
        self.datasets = [BucketDataset(b) for b in buckets]
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.host_index = host_index
        self.host_count = host_count
        self._index: list[tuple[int, int]] = [
            (di, bi)
            for di, ds in enumerate(self.datasets)
            for bi in range(len(ds))
        ]

    def __len__(self) -> int:
        return len(self._index[self.host_index :: self.host_count])

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        for ds in self.datasets:
            ds.bucket.epoch = epoch

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[dict[str, Any]]:
        """This epoch's batch stream starting at ``start_batch`` (mid-epoch
        resume: skipping happens at the INDEX level — skipped batches are
        never loaded or decoded, O(1) host work however deep the resume)."""
        for ds in self.datasets:
            ds.bucket.epoch = self.epoch
        order = list(self._index)
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        # per-host sharding: each host takes a strided slice of batches
        for di, bi in order[self.host_index :: self.host_count][start_batch:]:
            yield self.datasets[di][bi]
        self.epoch += 1
