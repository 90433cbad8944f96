"""Prebuild the image-size jsonl cache of a text-to-image folder (port of
``tools/data/create_buckets_cache.py``). The output feeds
``TextToImageDatasetConfig.imagesize_cache_path``, so a large folder skips
the per-image size probe at train start.

    python -m vision_pt_tpu_torch.tools.data.create_buckets_cache \\
        -i data/images -o data/images.sizes.jsonl
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import click
from tqdm import tqdm

from ...data.text_to_image import probe_image_size


def yield_tasks(input_path: str, supported_extensions, caption_extension,
                metadata_extension):
    """(image, caption or None, metadata or None) of every image with a
    caption or a metadata file beside it, walking the folder."""
    for root, _, files in os.walk(input_path):
        files_set = set(files)
        root_path = Path(root)
        for file_name in sorted(files):
            if not any(file_name.endswith(ext)
                       for ext in supported_extensions):
                continue
            file_path = root_path / file_name
            stem = file_path.stem
            caption = stem + caption_extension
            metadata = stem + metadata_extension
            caption_path = root_path / caption if caption in files_set else None
            metadata_path = (
                root_path / metadata if metadata in files_set else None
            )
            if caption_path is None and metadata_path is None:
                continue
            yield (file_path, caption_path, metadata_path)


def probe(entry):
    image_path, caption_path, metadata_path = entry
    try:
        width, height = probe_image_size(image_path)
    except Exception:
        return None
    return {
        "image": str(image_path),
        "width": width,
        "height": height,
        "caption": str(caption_path) if caption_path else None,
        "metadata": str(metadata_path) if metadata_path else None,
    }


@click.command()
@click.option("--input", "-i", "input_path", type=str, required=True)
@click.option("--output", "-o", "output_path", type=str, required=True)
@click.option("--caption_extension", default=".txt")
@click.option("--metadata_extension", default=".json")
@click.option("--num_workers", default=8, type=int)
def main(input_path, output_path, caption_extension, metadata_extension,
         num_workers):
    assert output_path.endswith(".jsonl")
    extensions = [".png", ".jpg", ".jpeg", ".webp", ".avif"]
    tasks = list(yield_tasks(input_path, extensions, caption_extension,
                             metadata_extension))
    print(f"{len(tasks)} images found")
    rows = []
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for row in tqdm(pool.map(probe, tasks), total=len(tasks)):
            if row is not None:
                rows.append(row)
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    print(f"Wrote {len(rows)} entries to {output_path}")


if __name__ == "__main__":
    main()
