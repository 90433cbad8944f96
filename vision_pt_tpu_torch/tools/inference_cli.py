"""Text-to-image generation from an SDXL checkpoint, with optional weight
quantization (port of ``tools/inference_cli.py``).

    python -m vision_pt_tpu_torch.tools.inference_cli \\
        --checkpoint-path sdxl.safetensors --tokenizer ./sdxl-tokenizers \\
        --prompt "photo of a cat" --quant-type bnb_nf4

The checkpoint is an sgm single-file safetensors and ``--tokenizer`` a local
directory holding the two CLIP tokenizers (``tokenizer/`` and
``tokenizer_2/``, HF layout), or ``word-hash`` for the vocabulary-free
stand-in. Nothing is downloaded. ``--model-config`` (YAML or JSON of
``SDXLConfig`` fields) changes the architecture, e.g. to a tiny one on the
CPU. Runs on the CUDA device unless ``--device`` names another.
:func:`run` is the part after loading: it quantizes and generates, so a
caller can drive it on a model it built itself.
"""

from __future__ import annotations

import argparse

import torch

from ..models.sdxl import SDXLConfig, SDXLModel
from ..models.sdxl.text_encoder import load_tokenizers
from ..ops.quant import quantize_inplace
from ..utils.tensor import tensor_to_images

QUANT_TYPES = ("bnb_nf4", "bnb_fp4", "bnb_int8", "quanto_int8", "fp8_e4m3fn")
# the UNet's linears that are quantized: attention, feed-forward and the
# transformer projections, not the embedders or the output head
INCLUDE_KEYS = ["attn", "ff", "proj_in", "proj_out"]
EXCLUDE_KEYS = ["time_embed", "label_emb", "out_"]


def run(model: SDXLModel, prompt: str = "photo of a cat",
        negative_prompt: str = "blurry, ugly, low quality", width: int = 768,
        height: int = 768, num_inference_steps: int = 20,
        cfg_scale: float = 5.0, seed: int = 42, quant_type: str | None = None,
        max_token_length: int = 225,
        save_path: str | None = None) -> torch.Tensor:
    """Quantize the UNet's linears (``quant_type``; a model quantized
    before keeps its layers), generate one image and save it. Returns the
    NHWC image in [-1, 1] on the model's device."""
    if quant_type is not None:
        quantize_inplace(model.denoiser, quant_type,
                         include_keys=INCLUDE_KEYS, exclude_keys=EXCLUDE_KEYS)
    latents = model.generate(
        prompt=prompt, negative_prompt=negative_prompt, width=width,
        height=height, num_inference_steps=num_inference_steps,
        cfg_scale=cfg_scale, seed=seed, max_token_length=max_token_length,
        return_latents=True,
    )
    with torch.inference_mode():
        images = model.decode_latents(latents,
                                      use_tiling=max(height, width) >= 1536)
    if save_path is not None:
        tensor_to_images(images)[0].save(save_path)
    return images


def _model_config(path: str | None, checkpoint_path: str) -> SDXLConfig:
    fields = {}
    if path is not None:
        import yaml

        with open(path) as f:
            fields = yaml.safe_load(f) or {}
    return SDXLConfig.model_validate({**fields, "checkpoint_path": checkpoint_path})


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint-path", required=True)
    parser.add_argument("--tokenizer", required=True,
                        help="a directory with tokenizer/ and tokenizer_2/, "
                             "or word-hash")
    parser.add_argument("--model-config", default=None)
    parser.add_argument("--prompt", default="photo of a cat")
    parser.add_argument("--negative-prompt", default="blurry, ugly, low quality")
    parser.add_argument("--width", default=768, type=int)
    parser.add_argument("--height", default=768, type=int)
    parser.add_argument("--num-inference-steps", default=20, type=int)
    parser.add_argument("--cfg-scale", default=5.0, type=float)
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--save-path", default="output.webp")
    parser.add_argument("--quant-type", default=None, choices=QUANT_TYPES)
    parser.add_argument("--max-token-length", default=225, type=int)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    config = _model_config(args.model_config, args.checkpoint_path)
    tokenizer_1, tokenizer_2 = load_tokenizers(args.tokenizer)
    print("Loading model...")
    model = SDXLModel.from_checkpoint(config, device=args.device,
                                      tokenizer_1=tokenizer_1,
                                      tokenizer_2=tokenizer_2)
    print(f"Prompt: {args.prompt}\nSize: {args.width}x{args.height} "
          f"steps={args.num_inference_steps} cfg={args.cfg_scale} "
          f"seed={args.seed} quant={args.quant_type}")
    run(model, args.prompt, args.negative_prompt, args.width, args.height,
        args.num_inference_steps, args.cfg_scale, args.seed, args.quant_type,
        args.max_token_length, save_path=args.save_path)
    print(f"Saved to {args.save_path}")


if __name__ == "__main__":
    main()
