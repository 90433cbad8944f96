"""SDXL RoPE-retrofit distillation entry point (port of
``train/sdxl/rope_distill.py``).

    python -m vision_pt_tpu_torch.train.sdxl.rope_distill --config CONFIG.yml

``model`` holds ``SDXLForRoPEDistillTrainingConfig`` fields (the LoRA
config's model with the distillation weights and ``lowres_ratio``). It
trains on the CUDA device; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import click

from ...training.trainer import Trainer
from ...workloads.sdxl_rope_distill import SDXLRoPEDistillTraining
from .text_to_image import train


def run(config_path: str, device: str | None = None) -> Trainer:
    """Train from a YAML config; returns the finished Trainer."""
    return train(config_path, device, SDXLRoPEDistillTraining)


@click.command()
@click.option("--config", "config_path", type=str, required=True)
@click.option("--device", type=str, default=None,
              help="torch device; the CUDA device when omitted")
def main(config_path: str, device: str | None):
    run(config_path, device)


if __name__ == "__main__":
    main()
