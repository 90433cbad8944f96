"""SDXL PFG (prompt-free generation) training on a referenced dataset, entry
point (port of ``train/sdxl/prompt_free.ref.py``; ``_`` stands for the file
name's ``.``, which ``python -m`` cannot take).

    python -m vision_pt_tpu_torch.train.sdxl.prompt_free_ref --config CONFIG.yml

``model.adapter`` holds the adapter's configuration. It trains on the CUDA
device; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import click

from ...data.referenced_text_to_image import ReferencedTextToImageDatasetConfig
from ...training.trainer import Trainer
from ...workloads.sdxl_prompt_free import SDXLPFGRefTraining
from .text_to_image import train


def run(config_path: str, device: str | None = None) -> Trainer:
    """Train from a YAML config; returns the finished Trainer."""
    return train(config_path, device, SDXLPFGRefTraining,
                 ReferencedTextToImageDatasetConfig)


@click.command()
@click.option("--config", "config_path", type=str, required=True)
@click.option("--device", type=str, default=None,
              help="torch device; the CUDA device when omitted")
def main(config_path: str, device: str | None):
    run(config_path, device)


if __name__ == "__main__":
    main()
