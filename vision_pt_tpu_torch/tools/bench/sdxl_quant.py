"""SDXL quantization x resolution bench (port of ``tools/bench/sdxl_quant.py``):
one cell of the matrix, its image, seconds and peak device memory.

    python -m vision_pt_tpu_torch.tools.bench.sdxl_quant \\
        --model_path sdxl.safetensors --denoiser bnb_nf4 --skip_offload

The record's ``peak_hbm_bytes`` is the CUDA allocator's peak over the timed
request (``torch.cuda.max_memory_allocated``), a measured number.
``static_denoiser_step_hbm`` stays in the record as ``None``: the JAX tool
fills it with XLA's compile-time memory analysis of the denoiser step when
its chip gives no runtime statistics, and PyTorch has no compile-time
analysis; the measured peak stands in for both. ``--skip_offload`` is kept
for the run name; this tool does not offload.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import click
import torch

DEFAULT_PROMPT = (
    "1girl, aqua eyes, baseball cap, blonde hair, closed mouth, earrings, "
    "green background, hat, hoop earrings, jewelry, looking at viewer, "
    "shirt, short hair, simple background, solo, upper body, yellow shirt, "
    "masterpiece"
)
DEFAULT_NEGATIVE = (
    "lowres, bad anatomy, bad hands, text, error, missing finger, cropped, "
    "worst quality, low quality, signature, watermark, username, blurry"
)


def quantize_model(model, text_encoder: str, denoiser: str):
    """Quantize the text encoders' attention and MLP linears and the UNet's
    attention and feed-forward linears, each unless its type is bf16."""
    from ...ops.quant import quantize_inplace

    if text_encoder != "bf16":
        for encoder in (model.text_encoder.text_encoder_1,
                        model.text_encoder.text_encoder_2):
            quantize_inplace(encoder, quant_type=text_encoder,
                             include_keys=["self_attn", ".mlp."])
    if denoiser != "bf16":
        quantize_inplace(model.denoiser, quant_type=denoiser,
                         include_keys=["attn1", "attn2", ".ff."])


def device_memory_bytes() -> int | None:
    from ...utils.memory import live_peak_bytes

    return live_peak_bytes()


def get_run_name(text_encoder: str, denoiser: str, skip_offload: bool) -> str:
    return (f"text-encoder-{text_encoder}_denoiser-{denoiser}"
            f"_offload-{not skip_offload}")


def run_cell(model, run_name: str, out_dir: Path, *, prompt: str = DEFAULT_PROMPT,
             negative_prompt: str = DEFAULT_NEGATIVE, height: int = 1024,
             width: int = 1024, cfg_scale: float = 5.0,
             num_inference_steps: int = 25, seed: int = 42) -> dict:
    """One warm-up request, then the timed one with the allocator's peak
    reset before it; writes ``<run_name>.webp`` and ``.json``."""
    def run():
        return model.generate(
            prompt=prompt, negative_prompt=negative_prompt,
            height=height, width=width, cfg_scale=cfg_scale,
            num_inference_steps=num_inference_steps, seed=seed,
        )[0]

    run()
    cuda = model.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    image = run()
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    out_dir.mkdir(parents=True, exist_ok=True)
    image.save(out_dir / f"{run_name}.webp")
    record = {
        "run": run_name, "height": height, "width": width,
        "steps": num_inference_steps, "seconds": round(elapsed, 3),
        "peak_hbm_bytes": device_memory_bytes() if cuda else None,
        "static_denoiser_step_hbm": None,
    }
    print(json.dumps(record))
    with open(out_dir / f"{run_name}.json", "w") as f:
        json.dump(record, f)
    return record


@click.command()
@click.option("--model_path", default="./models/animagine-xl-4.0-opt.safetensors")
@click.option("--text_encoder", default="bf16", type=str)
@click.option("--denoiser", default="bf16", type=str)
@click.option("--skip_offload", is_flag=True)
@click.option("--prompt", default=DEFAULT_PROMPT)
@click.option("--height", default=1024, type=int)
@click.option("--width", default=1024, type=int)
@click.option("--cfg_scale", default=5.0, type=float)
@click.option("--num_inference_steps", default=25, type=int)
@click.option("--seed", default=42, type=int)
@click.option("--save_dir", default="./output/bench/sdxl_quant")
@click.option("--tokenizer", default="word-hash",
              help="a directory with tokenizer/ and tokenizer_2/, or word-hash")
@click.option("--device", default=None, help="cuda (the default) or cpu")
def main(model_path, text_encoder, denoiser, skip_offload, prompt, height,
         width, cfg_scale, num_inference_steps, seed, save_dir, tokenizer, device):
    from ...models.sdxl import SDXLConfig, SDXLModel
    from ...models.sdxl.text_encoder import load_tokenizers

    tokenizer_1, tokenizer_2 = load_tokenizers(tokenizer)
    model = SDXLModel.from_checkpoint(
        SDXLConfig(checkpoint_path=model_path, dtype="bfloat16"), device=device,
        tokenizer_1=tokenizer_1, tokenizer_2=tokenizer_2)
    quantize_model(model, text_encoder, denoiser)
    run_cell(model, get_run_name(text_encoder, denoiser, skip_offload),
             Path(save_dir), prompt=prompt, height=height, width=width,
             cfg_scale=cfg_scale, num_inference_steps=num_inference_steps, seed=seed)


if __name__ == "__main__":
    main()
