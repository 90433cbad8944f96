"""One-command validation of a single-file SDXL checkpoint (port of
``tools/checkpoint/import_sdxl.py``). Given an sgm-layout safetensors file
(e.g. Illustrious-XL or animagine-xl) it

1. loads every submodel strictly through the key converters,
2. runs a denoiser forward at the full latent shape and checks its shape
   and finiteness,
3. generates an image end to end and saves it,
4. with ``--quant-matrix``, generates again with the UNet's attention and
   feed-forward linears in each of NF4, FP4, int8 and fp8.

    python -m vision_pt_tpu_torch.tools.checkpoint.import_sdxl \\
        --checkpoint-path model.safetensors --tokenizer ./sdxl-tokenizers

Runs on the CUDA device unless ``--device`` names another.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import click
import numpy as np
import torch

QUANT_TYPES = ("bnb_nf4", "bnb_fp4", "bnb_int8", "fp8_e4m3fn")


def run_import(
    config,
    out_dir: str,
    *,
    prompt: str = "1girl, solo, masterpiece, best quality",
    negative_prompt: str = "worst quality, low quality",
    cfg_scale: float = 5.0,
    num_inference_steps: int = 25,
    height: int = 1024,
    width: int = 1024,
    seed: int = 42,
    quant_matrix: bool = False,
    quant_types=QUANT_TYPES,
    tokenizers=None,
    execution_dtype: torch.dtype | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Strict load, forward, generate (and the quant matrix) on
    ``config.checkpoint_path``, an ``SDXLConfig``'s sgm file; ``tokenizers``
    is the (CLIP-L, bigG) pair, word-hash when None. Writes the images and
    ``report.json`` into ``out_dir`` and returns the report."""
    from ...models.sdxl import SDXLModel, WordHashTokenizer
    from ...ops.quant import quantize_inplace

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    report: dict = {"checkpoint": config.checkpoint_path}
    if tokenizers is None:
        tokenizers = (WordHashTokenizer(), WordHashTokenizer())

    def load_model():
        return SDXLModel.from_checkpoint(config, device=device,  # strict
                                         tokenizer_1=tokenizers[0],
                                         tokenizer_2=tokenizers[1])

    t0 = time.time()
    model = load_model()
    report["load_strict_s"] = round(time.time() - t0, 1)
    print(f"strict load OK in {report['load_strict_s']}s")

    fwd_dtype = execution_dtype or torch.bfloat16
    context_dim = model.denoiser.config.context_dim
    gen = torch.Generator(device=model.device).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=model.device).to(fwd_dtype)

    lat = normal(1, height // 8, width // 8, 4)
    ehs = normal(1, 77, context_dim)
    pooled = normal(1, 1280)
    sizes = torch.tensor([[float(height), float(width)]], device=model.device)
    crop = torch.zeros(1, 2, device=model.device)
    with torch.inference_mode():
        pred = model.denoiser(lat, torch.tensor([500.0], device=model.device), ehs,
                              pooled, sizes, sizes, crop)
    assert pred.shape == lat.shape, (pred.shape, lat.shape)
    assert bool(torch.isfinite(pred.float()).all())
    report["denoiser_forward"] = "ok"
    print("denoiser forward OK", tuple(pred.shape))
    del pred

    def generate(tag: str, gen_model):
        t = time.time()
        kw = {} if execution_dtype is None else {"execution_dtype": execution_dtype}
        images = gen_model.generate(
            prompt=prompt, negative_prompt=negative_prompt,
            width=width, height=height,
            num_inference_steps=num_inference_steps,
            cfg_scale=cfg_scale, seed=seed, **kw,
        )
        path = out / f"{tag}.webp"
        images[0].save(path)
        arr = np.asarray(images[0], dtype=np.float32)
        cell = {"seconds": round(time.time() - t, 1),
                "pixel_std": round(float(arr.std()), 2), "file": str(path)}
        print(f"[{tag}] {cell}")
        return cell

    report["bf16"] = generate("bf16", model)

    if quant_matrix:
        del model
        for qt in quant_types:
            qmodel = load_model()  # fresh weights
            quantize_inplace(
                qmodel.denoiser, qt,
                include_keys=["attn1", "attn2", ".ff."],
                exclude_keys=["time_embed", "label_emb"],
            )
            report[qt] = generate(qt, qmodel)
            del qmodel

    with open(out / "report.json", "w") as f:
        json.dump(report, f, indent=2)
    print(f"report: {out / 'report.json'}")
    return report


@click.command()
@click.option("--checkpoint-path", required=True, type=str)
@click.option("--out-dir", default="./output/import_sdxl", type=str)
@click.option("--prompt", default="1girl, solo, masterpiece, best quality")
@click.option("--negative-prompt", default="worst quality, low quality")
@click.option("--cfg-scale", default=5.0, type=float)
@click.option("--num-inference-steps", default=25, type=int)
@click.option("--height", default=1024, type=int)
@click.option("--width", default=1024, type=int)
@click.option("--seed", default=42, type=int)
@click.option("--quant-matrix", is_flag=True,
              help="also generate with each quantized-denoiser cell")
@click.option("--tokenizer", default="word-hash",
              help="a directory with tokenizer/ and tokenizer_2/, or word-hash")
@click.option("--device", default=None, help="cuda (the default) or cpu")
def main(checkpoint_path, out_dir, prompt, negative_prompt, cfg_scale,
         num_inference_steps, height, width, seed, quant_matrix, tokenizer, device):
    from ...models.sdxl import SDXLConfig
    from ...models.sdxl.text_encoder import load_tokenizers

    run_import(
        SDXLConfig(checkpoint_path=checkpoint_path),
        out_dir,
        prompt=prompt,
        negative_prompt=negative_prompt,
        cfg_scale=cfg_scale,
        num_inference_steps=num_inference_steps,
        height=height,
        width=width,
        seed=seed,
        quant_matrix=quant_matrix,
        tokenizers=load_tokenizers(tokenizer),
        device=device,
    )


if __name__ == "__main__":
    main()
