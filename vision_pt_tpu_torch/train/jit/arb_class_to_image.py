"""JiT aspect-ratio-bucket class-to-image training entry point (port of
``train/jit/arb_class_to_image.py``; e.g. ``configs/jit/x_loss/config.yml``).

    python -m vision_pt_tpu_torch.train.jit.arb_class_to_image --config CONFIG.yml

It trains on the CUDA device; ``--device cpu`` runs it on the CPU. The
dataset is an image folder with captions or ``.tags.json``-style metadata in
aspect-ratio buckets (``data/text_to_image.py``); the class tokenizer splits
each caption into labels.
"""

from __future__ import annotations

import click

from ...config import TrainConfig
from ...data.preview import TextToImagePreviewConfig
from ...data.text_to_image import TextToImageDatasetConfig
from ...training.model import ModelForTraining
from ...training.trainer import Trainer
from ...workloads.jit_variants import JiTForArbClassToImageTraining


def train(config_path: str, device: str | None,
          workload: type[ModelForTraining]) -> Trainer:
    """Train ``workload`` on the bucketed image folder of a YAML config;
    returns the finished Trainer. ``arb_class_to_image_ujit`` calls it too."""
    config = TrainConfig.from_config_file(config_path)
    trainer = Trainer(config, device=device)
    trainer.register_train_dataset_class(TextToImageDatasetConfig)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(workload)
    trainer.train()
    return trainer


def run(config_path: str, device: str | None = None) -> Trainer:
    """Train from a YAML config; returns the finished Trainer."""
    return train(config_path, device, JiTForArbClassToImageTraining)


@click.command()
@click.option("--config", "config_path", type=str, required=True)
@click.option("--device", type=str, default=None,
              help="torch device; the CUDA device when omitted")
def main(config_path: str, device: str | None):
    run(config_path, device)


if __name__ == "__main__":
    main()
