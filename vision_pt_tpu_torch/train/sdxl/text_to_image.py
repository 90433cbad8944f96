"""SDXL text-to-image fine-tuning entry point, LoRA / QLoRA / full (port of
``train/sdxl/text_to_image.py``).

    python -m vision_pt_tpu_torch.train.sdxl.text_to_image --config CONFIG.yml

e.g. ``configs/sdxl/text_to_image_lora.yml`` or
``text_to_image_qlora_nf4.yml``, with ``model.tokenizer`` naming the CLIP
tokenizers' directory (or ``word-hash``). It trains on the CUDA device;
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import click

from ...config import TrainConfig
from ...data.preview import TextToImagePreviewConfig
from ...data.text_to_image import TextToImageDatasetConfig
from ...training.model import ModelForTraining
from ...training.trainer import Trainer
from ...workloads.sdxl_text_to_image import SDXLForTextToImageTraining


def train(config_path: str, device: str | None, workload: type[ModelForTraining],
          dataset: type = TextToImageDatasetConfig) -> Trainer:
    """Train ``workload`` on ``dataset`` from a YAML config; returns the
    finished Trainer. The other SDXL entry points call it too."""
    trainer = Trainer(TrainConfig.from_config_file(config_path), device=device)
    trainer.register_train_dataset_class(dataset)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(workload)
    trainer.train()
    return trainer


def run(config_path: str, device: str | None = None) -> Trainer:
    """Train from a YAML config; returns the finished Trainer."""
    return train(config_path, device, SDXLForTextToImageTraining)


@click.command()
@click.option("--config", "config_path", type=str, required=True)
@click.option("--device", type=str, default=None,
              help="torch device; the CUDA device when omitted")
def main(config_path: str, device: str | None):
    run(config_path, device)


if __name__ == "__main__":
    main()
