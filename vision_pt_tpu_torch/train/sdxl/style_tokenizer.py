"""SDXL style tokenizer training entry point (port of
``train/sdxl/style_tokenizer.py``), on a referenced dataset.

    python -m vision_pt_tpu_torch.train.sdxl.style_tokenizer --config CONFIG.yml

``model.adapter`` holds the ``StyleTokenizerConfig`` (its vision tower's
``weights_path`` among them); the captions carry ``<|style|>``. It trains
on the CUDA device; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import click

from ...data.referenced_text_to_image import ReferencedTextToImageDatasetConfig
from ...training.trainer import Trainer
from ...workloads.sdxl_style_tokenizer import SDXLStyleTokenizerTraining
from .text_to_image import train


def run(config_path: str, device: str | None = None) -> Trainer:
    """Train from a YAML config; returns the finished Trainer."""
    return train(config_path, device, SDXLStyleTokenizerTraining,
                 ReferencedTextToImageDatasetConfig)


@click.command()
@click.option("--config", "config_path", type=str, required=True)
@click.option("--device", type=str, default=None,
              help="torch device; the CUDA device when omitted")
def main(config_path: str, device: str | None):
    run(config_path, device)


if __name__ == "__main__":
    main()
