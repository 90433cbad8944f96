"""A torch ``.pt`` / ``.ckpt`` file to safetensors (port of
``tools/checkpoint/to_safetensors.py``): the tensors of the file, of its
``state_dict`` entry, or of ``--key``; bfloat16 tensors are written as
float32, as the JAX tool writes them.

    python -m vision_pt_tpu_torch.tools.checkpoint.to_safetensors \\
        -i model.ckpt -o model.safetensors
"""

from __future__ import annotations

import click
import torch


@click.command()
@click.option("--input", "-i", "input_path", type=str, required=True)
@click.option("--output", "-o", "output_path", type=str, required=True)
@click.option("--key", type=str, default=None,
              help="sub-dict key inside the checkpoint (e.g. 'state_dict')")
def main(input_path: str, output_path: str, key: str | None):
    from safetensors.torch import save_file

    print("Loading", input_path)
    obj = torch.load(input_path, map_location="cpu", weights_only=True)
    if key is not None:
        obj = obj[key]
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    tensors = {
        k: (v.detach().float() if v.dtype == torch.bfloat16 else v.detach()).contiguous()
        for k, v in obj.items()
        if isinstance(v, torch.Tensor)
    }
    print(f"{len(tensors)} tensors")
    save_file(tensors, output_path)
    print("Saved to", output_path)


if __name__ == "__main__":
    main()
