"""Cast every floating tensor of a safetensors checkpoint (port of
``tools/checkpoint/change_dtype.py``); integer tensors stay as they are.
bfloat16 is written as safetensors ``BF16`` through torch.

    python -m vision_pt_tpu_torch.tools.checkpoint.change_dtype \\
        -i model.safetensors -o model.bf16.safetensors --dtype bfloat16
"""

from __future__ import annotations

import click
import torch


@click.command()
@click.option("--input", "-i", "input_path", type=str, required=True)
@click.option("--output", "-o", "output_path", type=str, required=True)
@click.option("--dtype", type=click.Choice(
    ["float32", "float16", "bfloat16"]), default="bfloat16")
def main(input_path: str, output_path: str, dtype: str):
    from safetensors.torch import load_file, save_file

    target = getattr(torch, dtype)
    state = load_file(input_path)
    out = {k: v.to(target) if v.is_floating_point() else v
           for k, v in state.items()}
    save_file(out, output_path)
    print(f"Saved {len(out)} tensors as {dtype} to {output_path}")


if __name__ == "__main__":
    main()
