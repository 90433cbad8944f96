"""Build a label2id map from danbooru-style tag JSONs (port of
``tools/data/create_label2id.py``): the ratings, every character tag and
the general tags seen at least ``-g`` times, each group sorted.

    python -m vision_pt_tpu_torch.tools.data.create_label2id \\
        -t data/tags -o label2id.json -g 100
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from pathlib import Path

import click
from tqdm import tqdm


def collect_tag_data(tags_dir: Path) -> list[dict]:
    all_data = []
    for root, _dirs, files in os.walk(tags_dir):
        for file in tqdm(sorted(files)):
            if not file.endswith(".json"):
                continue
            with open(os.path.join(root, file)) as f:
                all_data.append(json.load(f))
    return all_data


def build_label2id(all_data: list[dict], character_threshold: int,
                   general_threshold: int) -> tuple[dict, dict]:
    """labels = sorted ratings + sorted character tags (all of them, as the
    JAX tool does whatever ``character_threshold``) + sorted general tags
    with at least ``general_threshold`` occurrences."""
    ratings = set()
    character_count: dict[str, int] = defaultdict(int)
    general_count: dict[str, int] = defaultdict(int)
    for data in all_data:
        ratings.add(data.get("rating", "general"))
        for tag in data.get("character_tags", {}).keys():
            character_count[tag] += 1
        for tag in data.get("general_tags", {}).keys():
            general_count[tag] += 1

    popular_general = {
        t for t, c in general_count.items() if c >= general_threshold
    }
    all_labels = (
        sorted(ratings)
        + sorted(character_count.keys())
        + sorted(popular_general)
    )
    label2id = {label: idx for idx, label in enumerate(all_labels)}
    counts = {
        "ratings": len(ratings),
        "characters": dict(character_count),
        "general": dict(general_count),
        "total": len(all_labels),
    }
    return label2id, counts


@click.command()
@click.option("--tags_dir", "-t", type=Path, required=True)
@click.option("--output", "-o", type=Path, required=True)
@click.option("--character_threshold", "-c", type=int, default=10)
@click.option("--general_threshold", "-g", type=int, default=100)
def main(tags_dir: Path, output: Path, character_threshold: int,
         general_threshold: int):
    all_data = collect_tag_data(tags_dir)
    label2id, counts = build_label2id(
        all_data, character_threshold, general_threshold
    )
    print(f"{counts['total']} labels "
          f"({counts['ratings']} ratings, "
          f"{len(counts['characters'])} characters)")
    with open(output, "w") as f:
        json.dump(label2id, f, ensure_ascii=False, indent=2)
    print(f"Wrote {output}")


if __name__ == "__main__":
    main()
