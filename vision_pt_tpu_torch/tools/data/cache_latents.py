"""The batched VAE-latent caching pass (port of ``tools/data/cache_latents.py``).

Walks an aspect-ratio-bucketed image folder (``.txt`` captions beside the
images), encodes every bucket batch with the SDXL VAE and writes the latent
cache that ``CachedLatentDatasetConfig`` serves at train time, e.g. for
``configs/jit/latent_arb_1024.yml``:

    python -m vision_pt_tpu_torch.tools.data.cache_latents \\
        --folder data/images --cache-dir cache/latents_1024 \\
        --bucket-base-size 1024 --checkpoint models/sdxl.safetensors

``--checkpoint`` is an sgm single-file SDXL checkpoint (its ``vae.`` weights);
without it (and without ``--vae-config``) the SDXL VAE has random weights,
which is only good for smoke tests. It runs on the CUDA device; ``--device
cpu`` runs it on the CPU.
"""

from __future__ import annotations

import json

import click
import numpy as np
import torch

from ...data.latent_cache import cache_latents
from ...data.text_to_image import TextToImageDatasetConfig
from ...models.sdxl.convert import (
    convert_from_original_key,
    fix_vae_attention_projections,
    torch_to_port_key,
)
from ...models.sdxl.vae import VAE
from ...utils import resolve_device


def load_vae_weights(vae: VAE, checkpoint: str) -> None:
    """The ``vae.`` tensors of an sgm single-file checkpoint, through the
    port's key conversion and the VAE projection fix."""
    from safetensors.numpy import load_file

    sd = {convert_from_original_key(k): v for k, v in load_file(checkpoint).items()}
    vae_sd = fix_vae_attention_projections(
        {k.removeprefix("vae."): v for k, v in sd.items() if k.startswith("vae.")})
    vae.load_state_dict({torch_to_port_key(k): torch.from_numpy(np.array(v))
                         for k, v in vae_sd.items()}, strict=True)


def build_vae(checkpoint: str | None = None, vae_config: dict | None = None,
              device: str | torch.device | None = None) -> VAE:
    """The SDXL VAE (or ``vae_config``'s) on ``device``, random from seed 0,
    then the checkpoint's weights when one is given."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(0)
    with device:
        vae = (VAE(**vae_config, generator=generator) if vae_config
               else VAE.from_default(generator=generator)).eval()
    if checkpoint:
        load_vae_weights(vae, checkpoint)
    return vae


def run(folder: str, cache_dir: str, checkpoint: str | None = None,
        vae_config: dict | None = None, bucket_base_size: int = 1024, step: int = 64,
        min_size: int = 384, batch_size: int = 8, num_workers: int = 8,
        dtype: str = "float16", device: str | None = None) -> str:
    """Cache ``folder``'s latents under ``cache_dir``; returns the manifest
    path."""
    dataset = TextToImageDatasetConfig(
        folder=folder, batch_size=batch_size, num_workers=num_workers,
        bucket_base_size=bucket_base_size, step=step, min_size=min_size,
        shuffle=False, num_repeats=1,
    ).get_dataset()
    vae = build_vae(checkpoint, vae_config, device)
    if checkpoint:
        print(f"[cache_latents] VAE weights from {checkpoint}")
    return cache_latents(dataset, vae, cache_dir,
                         dtype={"float16": torch.float16, "bfloat16": torch.bfloat16}[dtype])


@click.command()
@click.option("--folder", type=str, required=True)
@click.option("--cache-dir", type=str, required=True)
@click.option("--checkpoint", type=str, default=None,
              help="SDXL single-file checkpoint to pull VAE weights from")
@click.option("--vae-config", type=str, default=None,
              help="JSON dict overriding the VAE architecture")
@click.option("--bucket-base-size", type=int, default=1024)
@click.option("--step", type=int, default=64)
@click.option("--min-size", type=int, default=384)
@click.option("--batch-size", type=int, default=8)
@click.option("--num-workers", type=int, default=8)
@click.option("--dtype", type=click.Choice(["float16", "bfloat16"]),
              default="float16", help="storage dtype for cached latents")
@click.option("--device", type=str, default=None,
              help="torch device; the CUDA device when omitted")
def main(folder, cache_dir, checkpoint, vae_config, bucket_base_size, step,
         min_size, batch_size, num_workers, dtype, device):
    manifest = run(folder, cache_dir, checkpoint,
                   json.loads(vae_config) if vae_config else None, bucket_base_size,
                   step, min_size, batch_size, num_workers, dtype, device)
    print(f"[cache_latents] manifest: {manifest}")


if __name__ == "__main__":
    main()
