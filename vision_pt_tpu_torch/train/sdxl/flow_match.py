"""SDXL flow-match conversion training entry point (port of
``train/sdxl/flow_match.py``).

    python -m vision_pt_tpu_torch.train.sdxl.flow_match --config CONFIG.yml

e.g. ``configs/sdxl/flow_match/config.yml``, with ``model.tokenizer`` naming
the CLIP tokenizers' directory (or ``word-hash``). It trains on the CUDA
device; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import click

from ...config import TrainConfig
from ...data.preview import TextToImagePreviewConfig
from ...data.text_to_image import TextToImageDatasetConfig
from ...training.trainer import Trainer
from ...workloads.sdxl_flow_match import SDXLForFlowMatchingTraining


def run(config_path: str, device: str | None = None) -> Trainer:
    """Train from a YAML config; returns the finished Trainer."""
    trainer = Trainer(TrainConfig.from_config_file(config_path), device=device)
    trainer.register_train_dataset_class(TextToImageDatasetConfig)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(SDXLForFlowMatchingTraining)
    trainer.train()
    return trainer


@click.command()
@click.option("--config", "config_path", type=str, required=True)
@click.option("--device", type=str, default=None,
              help="torch device; the CUDA device when omitted")
def main(config_path: str, device: str | None):
    run(config_path, device)


if __name__ == "__main__":
    main()
