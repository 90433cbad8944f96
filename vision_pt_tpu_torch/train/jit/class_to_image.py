"""JiT class-to-image training entry point (port of
``train/jit/class_to_image.py``).

    python -m vision_pt_tpu_torch.train.jit.class_to_image --config CONFIG.yml

It trains on the CUDA device; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import click

from ...config import TrainConfig
from ...data.preview import TextToImagePreviewConfig
from ...data.square_class_image import (
    SquareClassImageDatasetConfig,
    SyntheticClassImageDatasetConfig,
)
from ...training.model import ModelForTraining
from ...training.trainer import Trainer
from ...workloads.jit_class_to_image import JiTForClassToImageTraining


def _dataset_class(dataset_cfg: dict):
    if dataset_cfg.get("type") == "synthetic":
        return SyntheticClassImageDatasetConfig
    return SquareClassImageDatasetConfig


def train(config_path: str, device: str | None,
          workload: type[ModelForTraining]) -> Trainer:
    """Train ``workload`` on the square (or, with ``dataset.type:
    synthetic``, synthetic) class-image dataset of a YAML config; returns the
    finished Trainer. The JiT variants' entry points call it too."""
    config = TrainConfig.from_config_file(config_path)
    trainer = Trainer(config, device=device)
    dataset_cfg = dict(config.dataset)
    ds_class = _dataset_class(dataset_cfg)
    dataset_cfg.pop("type", None)
    config.dataset = dataset_cfg
    trainer.register_train_dataset_class(ds_class)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(workload)
    trainer.train()
    return trainer


def run(config_path: str, device: str | None = None) -> Trainer:
    """Train from a YAML config; returns the finished Trainer."""
    return train(config_path, device, JiTForClassToImageTraining)


@click.command()
@click.option("--config", "config_path", type=str, required=True)
@click.option("--device", type=str, default=None,
              help="torch device; the CUDA device when omitted")
def main(config_path: str, device: str | None):
    run(config_path, device)


if __name__ == "__main__":
    main()
