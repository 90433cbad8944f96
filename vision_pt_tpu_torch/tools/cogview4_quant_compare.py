"""CogView4 dense-vs-quantized comparison (port of
``tools/cogview4_quant_compare.py``): generate the same prompt and seed under
each quantization of the DiT and report the seconds, the PSNR against the
first setting (bf16) and the peak device memory of each.

    python -m vision_pt_tpu_torch.tools.cogview4_quant_compare \\
        --model_path cogview4.safetensors --tokenizer ./glm-4-tokenizer

The checkpoint is a single file in the original layout (``diffusion_model.*``,
``vae.*``; the GLM tower keeps its random weights, as in the JAX package's
tool) and ``--tokenizer`` a local
directory with the GLM-4 tokenizer, or ``word-hash`` for the
vocabulary-free stand-in. Nothing is downloaded. ``--model-config`` (YAML or
JSON of ``CogView4Config`` fields) changes the architecture, e.g. to a tiny
one on the CPU. Runs on the CUDA device unless ``--device`` names another.
:func:`compare` is the part after the arguments: it takes a model factory,
so a caller can drive it on models it builds itself.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..models.cogview4 import CogView4Config, CogView4Model
from ..models.cogview4.text_encoder import load_tokenizer
from ..ops.quant import quantize_inplace
from ..utils.tensor import tensor_to_images

TEXT_ENCODER_KEYS = (["q_proj", "k_proj", "v_proj", "o_proj", "mlp.down_proj",
                      "mlp.gate_up_proj"], ["denoiser.", "vae."])
DEFAULT_PROMPT = "a photo of a cat wearing a tiny hat"
DENOISER_KEYS = (["to_q", "to_k", "to_v", "to_out", "ff."],
                 ["time_condition_embed", "patch_embed", "norm_out", "proj_out",
                  "norm1", "text_encoder.", "vae."])


def _module_tree(model: CogView4Model) -> nn.ModuleDict:
    """The model's module attributes, as the JAX package's walk finds them:
    the text encoder is a plain object holding its LM, so it is not among
    them and its linears are never quantized."""
    return nn.ModuleDict({name: value for name, value in vars(model).items()
                          if isinstance(value, nn.Module) and not name.startswith("_")})


def quantize_model(model: CogView4Model, text_encoder: str,
                   denoiser: str) -> dict[str, list[str]]:
    """Quantize the text encoder's and the DiT's target linears ("bf16"
    leaves them). Returns the replaced paths of each."""
    replaced = {"text_encoder": [], "denoiser": []}
    for part, quant, (include, exclude) in (
            ("text_encoder", text_encoder, TEXT_ENCODER_KEYS),
            ("denoiser", denoiser, DENOISER_KEYS)):
        if quant != "bf16":
            replaced[part] = quantize_inplace(_module_tree(model), quant, include,
                                              exclude)
    return replaced


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(255.0**2 / mse))


def compare(make_model: Callable[[], CogView4Model],
            prompt: str = DEFAULT_PROMPT, height: int = 512,
            width: int = 512, num_inference_steps: int = 20, cfg_scale: float = 5.0,
            seed: int = 42, denoiser_quants: str = "bf16,bnb_nf4,bnb_int8",
            save_dir: str | None = None, warmup_steps: int = 0,
            before_timed: Callable[[str], None] | None = None,
            after_timed: Callable | None = None) -> dict:
    """For each setting: build a model (``make_model()``), quantize its DiT,
    run ``warmup_steps`` of a request if any, then the timed request (the
    decode included). ``before_timed(quant)`` runs just before it and
    ``after_timed(quant, model, images, request)`` just after, with the NHWC
    images in [-1, 1] and ``request(steps, **generate_kw)``. With
    ``save_dir``, the images and ``results.json`` are written there."""
    out_dir = Path(save_dir) if save_dir is not None else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    results, reference = {}, None
    for quant in denoiser_quants.split(","):
        t0 = time.perf_counter()
        model = make_model()
        cuda = model.device.type == "cuda"

        def sync():
            if cuda:
                torch.cuda.synchronize(model.device)

        sync()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        replaced = quantize_model(model, "bf16", quant)
        sync()
        quantize_s = time.perf_counter() - t0
        if cuda:
            torch.cuda.empty_cache()

        def request(steps, **kw):
            return model.generate(prompt=prompt, height=height, width=width,
                                  num_inference_steps=steps, cfg_scale=cfg_scale,
                                  seed=seed, **kw)

        if warmup_steps:
            request(warmup_steps, return_latents=True)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(model.device)
        if before_timed is not None:
            before_timed(quant)
        t0 = time.perf_counter()
        images = model.decode_latents(request(num_inference_steps,
                                              return_latents=True))
        sync()
        elapsed = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(model.device) if cuda else None
        image = tensor_to_images(images)[0]
        pixels = np.asarray(image)
        if reference is None:
            reference = pixels
        results[quant] = {
            "seconds": elapsed,
            "steps_per_second": num_inference_steps / elapsed,
            "psnr_vs_bf16": psnr(reference, pixels),
            "peak_memory_bytes": peak,
            "build_seconds": build_s,
            "quantize_seconds": quantize_s,
            "quantized_linears": {k: len(v) for k, v in replaced.items()},
        }
        if after_timed is not None:
            after_timed(quant, model, images, request)
        if out_dir is not None:
            image.save(out_dir / f"denoiser-{quant}.webp")
        print(quant, results[quant], flush=True)
        del model, images, request
        if cuda:
            torch.cuda.empty_cache()
    if out_dir is not None:
        with open(out_dir / "results.json", "w") as f:
            json.dump(results, f, indent=2)
    return results


def _model_config(path: str | None, checkpoint_path: str) -> CogView4Config:
    fields = {}
    if path is not None:
        import yaml

        with open(path) as f:
            fields = yaml.safe_load(f) or {}
    return CogView4Config.model_validate(
        {"dtype": "bfloat16", **fields, "checkpoint_path": checkpoint_path})


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--prompt", default=DEFAULT_PROMPT)
    parser.add_argument("--height", default=512, type=int)
    parser.add_argument("--width", default=512, type=int)
    parser.add_argument("--num_inference_steps", default=20, type=int)
    parser.add_argument("--cfg_scale", default=5.0, type=float)
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--denoiser_quants", default="bf16,bnb_nf4,bnb_int8")
    parser.add_argument("--save_dir", default="./output/cogview4_quant_compare")
    parser.add_argument("--tokenizer", required=True,
                        help="a directory with the GLM-4 tokenizer, or word-hash")
    parser.add_argument("--model-config", default=None)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    config = _model_config(args.model_config, args.model_path)
    tokenizer = load_tokenizer(args.tokenizer)
    results = compare(
        lambda: CogView4Model.from_checkpoint(config, tokenizer=tokenizer,
                                              device=args.device),
        args.prompt, args.height, args.width, args.num_inference_steps,
        args.cfg_scale, args.seed, args.denoiser_quants, args.save_dir)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
