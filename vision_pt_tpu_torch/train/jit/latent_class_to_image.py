"""Latent-space JiT training on cached VAE latents (port of
``train/jit/latent_class_to_image.py``; the ARB workload over
``data/latent_cache.py``, e.g. ``configs/jit/latent_arb_1024.yml``).

    python -m vision_pt_tpu_torch.train.jit.latent_class_to_image --config CONFIG.yml

It trains on the CUDA device; ``--device cpu`` runs it on the CPU. The cache
is written from an image folder by the port's
``python -m vision_pt_tpu_torch.tools.data.cache_latents``.
"""

from __future__ import annotations

import click

from ...config import TrainConfig
from ...data.latent_cache import CachedLatentDatasetConfig
from ...data.preview import TextToImagePreviewConfig
from ...training.trainer import Trainer
from ...workloads.jit_variants import JiTForArbClassToImageTraining


def run(config_path: str, device: str | None = None) -> Trainer:
    """Train from a YAML config; returns the finished Trainer."""
    config = TrainConfig.from_config_file(config_path)
    trainer = Trainer(config, device=device)
    trainer.register_train_dataset_class(CachedLatentDatasetConfig)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(JiTForArbClassToImageTraining)
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
