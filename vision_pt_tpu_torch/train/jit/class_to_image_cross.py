"""JiT Cross-JiT (cross-attention context) training entry point (port of
``train/jit/class_to_image_cross.py``).

    python -m vision_pt_tpu_torch.train.jit.class_to_image_cross --config CONFIG.yml

It trains on the CUDA device; ``--device cpu`` runs it on the CPU. The
dataset is the square class-image folder, or the synthetic one with
``dataset.type: synthetic``.
"""

from __future__ import annotations

import click

from ...training.trainer import Trainer
from ...workloads.jit_variants import JiTForCrossTraining
from .class_to_image import train


def run(config_path: str, device: str | None = None) -> Trainer:
    """Train from a YAML config; returns the finished Trainer."""
    return train(config_path, device, JiTForCrossTraining)


@click.command()
@click.option("--config", "config_path", type=str, required=True)
@click.option("--device", type=str, default=None,
              help="torch device; the CUDA device when omitted")
def main(config_path: str, device: str | None):
    run(config_path, device)


if __name__ == "__main__":
    main()
