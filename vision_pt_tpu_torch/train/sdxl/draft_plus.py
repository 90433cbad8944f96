"""SDXL DRaFT+ reward fine-tuning entry point (port of
``train/sdxl/draft_plus.py``).

    python -m vision_pt_tpu_torch.train.sdxl.draft_plus --config CONFIG.yml

``model`` holds ``SDXLForDRaFTPlusTrainingConfig`` fields, ``reward_models``
among them (``{type: pickscore, weights_path: DIR, tokenizer: word-hash}``
or ``{type: brightness}``); ``peft`` must be set (the reference model is the
adapters off). It trains on the CUDA device; ``--device cpu`` runs it on
the CPU.
"""

from __future__ import annotations

import click

from ...training.trainer import Trainer
from ...workloads.sdxl_draft_plus import SDXLDRaFTPlusTraining
from .text_to_image import train


def run(config_path: str, device: str | None = None) -> Trainer:
    """Train from a YAML config; returns the finished Trainer."""
    return train(config_path, device, SDXLDRaFTPlusTraining)


@click.command()
@click.option("--config", "config_path", type=str, required=True)
@click.option("--device", type=str, default=None,
              help="torch device; the CUDA device when omitted")
def main(config_path: str, device: str | None):
    run(config_path, device)


if __name__ == "__main__":
    main()
