"""Offline checkpoint quantization (port of ``tools/quantize_model.py``).
Packs the matching weights of a safetensors checkpoint into bnb-format 4-bit
(or fp8) tensors with their quant states, a self-describing file that
``load_state_with_prequantized`` (``SDXLModel.from_checkpoint``) loads, e.g.
the NF4 checkpoint of ``configs/sdxl/text_to_image_qlora_nf4.yml``:

    python -m vision_pt_tpu_torch.tools.quantize_model \\
        --model-path sdxl.safetensors --save-path sdxl.nf4.safetensors

4-bit weights are quantized on the CUDA device (the same codes as the host
path); ``--device cpu`` quantizes them with numpy instead.
"""

from __future__ import annotations

import time

import click
import numpy as np
import torch

from ..ops.quant.functional import quantize_state_dict
from ..utils import resolve_device

INCLUDE_KEYS = ("model.diffusion_model.",)
EXCLUDE_KEYS = ("time_embed", "label_emb", "out.")


def quantize_file(model_path: str, save_path: str, quant_type: str = "bnb_nf4",
                  include_keys=INCLUDE_KEYS, exclude_keys=EXCLUDE_KEYS,
                  device: str | torch.device | None = None) -> dict:
    """Load ``model_path``, quantize the keys that ``include_keys`` match and
    ``exclude_keys`` do not, and write ``save_path``. ``device`` None means
    the CUDA device; ``"cpu"`` is the numpy path. Returns the quantized
    tensors' count, the keys and the seconds of the load, the quantization
    and the write."""
    from safetensors.numpy import load_file, save_file

    device = resolve_device(device)
    print("Include keys:", list(include_keys))
    print("Exclude keys:", list(exclude_keys))
    print("Loading state dict from", model_path)
    t0 = time.perf_counter()
    state_dict = load_file(model_path)
    t1 = time.perf_counter()
    print(f"Quantizing {quant_type}...")
    out = quantize_state_dict(
        state_dict, quant_type, include_keys=list(include_keys),
        exclude_keys=list(exclude_keys),
        device=None if device.type == "cpu" else device)
    suffix = ".quant_state.bitsandbytes__" + quant_type.removeprefix("bnb_")
    n_quant = sum(1 for k in out if k.endswith(suffix))
    print(f"Quantized tensors: {n_quant}; total keys {len(out)}")
    t2 = time.perf_counter()
    if any(isinstance(v, torch.Tensor) for v in out.values()):  # fp8 weights
        from safetensors.torch import save_file as save_torch

        save_torch({k: v.contiguous() if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.array(v)) for k, v in out.items()}, save_path)
    else:
        save_file({k: np.ascontiguousarray(v) for k, v in out.items()}, save_path)
    print("Saved to", save_path)
    return {"quantized": n_quant, "keys": len(out), "load_seconds": t1 - t0,
            "quantize_seconds": t2 - t1, "write_seconds": time.perf_counter() - t2}


@click.command()
@click.option("--model-path", type=str, required=True)
@click.option("--save-path", type=str, required=True)
@click.option("--quant-type", default="bnb_nf4",
              type=click.Choice(["bnb_nf4", "bnb_fp4", "fp8_e4m3fn"]))
@click.option("--include-keys", multiple=True, default=list(INCLUDE_KEYS))
@click.option("--exclude-keys", multiple=True, default=list(EXCLUDE_KEYS))
@click.option("--device", type=str, default=None,
              help="cuda (the default) or cpu")
def main(model_path, save_path, quant_type, include_keys, exclude_keys, device):
    quantize_file(model_path, save_path, quant_type, include_keys, exclude_keys,
                  device)


if __name__ == "__main__":
    main()
