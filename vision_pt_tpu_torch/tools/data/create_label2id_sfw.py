"""Build an SFW-filtered label2id map (port of
``tools/data/create_label2id_sfw.py``): tag JSONs read on a thread pool,
underscores normalized (``data.tags.map_replace_underscore``), copyright
tags included, explicit ratings left out.

    python -m vision_pt_tpu_torch.tools.data.create_label2id_sfw \\
        -i data/tags -o label2id_sfw.json
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import click
from tqdm import tqdm

from ...data.tags import map_replace_underscore

SFW_RATINGS = {"general", "sensitive"}


def load_json_file(filepath: str) -> dict | None:
    try:
        with open(filepath) as f:
            return json.load(f)
    except Exception:
        return None


def _popular(counts: dict[str, int], threshold: int) -> set[str]:
    return {t for t, c in counts.items() if c >= threshold}


@click.command()
@click.option("--input", "-i", "tags_dir", type=Path, required=True)
@click.option("--output", "-o", type=Path, required=True)
@click.option("--character_threshold", "-ch", type=int, default=10)
@click.option("--copyright_threshold", "-cp", type=int, default=10)
@click.option("--general_threshold", "-g", type=int, default=100)
@click.option("--num_workers", type=int, default=8)
def main(tags_dir: Path, output: Path, character_threshold: int,
         copyright_threshold: int, general_threshold: int, num_workers: int):
    paths = []
    for root, _dirs, files in os.walk(tags_dir):
        paths += [os.path.join(root, f) for f in files if f.endswith(".json")]

    ratings = set()
    character_count: dict[str, int] = defaultdict(int)
    copyright_count: dict[str, int] = defaultdict(int)
    general_count: dict[str, int] = defaultdict(int)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for data in tqdm(pool.map(load_json_file, paths), total=len(paths)):
            if data is None:
                continue
            rating = data.get("rating", "general")
            if rating not in SFW_RATINGS:
                continue
            ratings.add(rating)
            for tag in map_replace_underscore(
                list(data.get("character_tags", {}).keys())
            ):
                character_count[tag] += 1
            for tag in map_replace_underscore(
                list(data.get("copyright_tags", {}).keys())
            ):
                copyright_count[tag] += 1
            for tag in map_replace_underscore(
                list(data.get("general_tags", {}).keys())
            ):
                general_count[tag] += 1

    all_labels = (
        sorted(ratings)
        + sorted(_popular(character_count, character_threshold))
        + sorted(_popular(copyright_count, copyright_threshold))
        + sorted(_popular(general_count, general_threshold))
    )
    label2id = {label: idx for idx, label in enumerate(all_labels)}
    print(f"{len(all_labels)} labels")
    with open(output, "w") as f:
        json.dump(label2id, f, ensure_ascii=False, indent=2)
    print(f"Wrote {output}")


if __name__ == "__main__":
    main()
