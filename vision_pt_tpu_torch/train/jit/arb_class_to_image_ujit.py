"""U-JiT aspect-ratio-bucket class-to-image training entry point (port of
``train/jit/arb_class_to_image_ujit.py``).

    python -m vision_pt_tpu_torch.train.jit.arb_class_to_image_ujit --config CONFIG.yml

It trains on the CUDA device; ``--device cpu`` runs it on the CPU. The
dataset is the bucketed image folder of ``arb_class_to_image``.
"""

from __future__ import annotations

import click

from ...training.trainer import Trainer
from ...workloads.jit_variants import JiTForArbUJiTTraining
from .arb_class_to_image import train


def run(config_path: str, device: str | None = None) -> Trainer:
    """Train from a YAML config; returns the finished Trainer."""
    return train(config_path, device, JiTForArbUJiTTraining)


@click.command()
@click.option("--config", "config_path", type=str, required=True)
@click.option("--device", type=str, default=None,
              help="torch device; the CUDA device when omitted")
def main(config_path: str, device: str | None):
    run(config_path, device)


if __name__ == "__main__":
    main()
