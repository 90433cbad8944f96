"""Checkpoint key / shape / dtype dump (port of
``tools/model/inspect_weights.py``).

    python -m vision_pt_tpu_torch.tools.model.inspect_weights \\
        -i model.safetensors [-f attn1] [--stats]
"""

from __future__ import annotations

import click


@click.command()
@click.option("--input", "-i", "input_path", type=str, required=True)
@click.option("--filter", "-f", "key_filter", type=str, default=None)
@click.option("--stats", is_flag=True, help="also print min/max/mean/std")
def main(input_path: str, key_filter: str | None, stats: bool):
    from safetensors import safe_open

    total_params = 0
    total_bytes = 0
    with safe_open(input_path, framework="pt") as f:
        keys = sorted(f.keys())
        for k in keys:
            if key_filter and key_filter not in k:
                continue
            t = f.get_tensor(k)
            total_params += t.numel()
            total_bytes += t.numel() * t.element_size()
            line = f"{k}  {tuple(t.shape)}  {str(t.dtype).removeprefix('torch.')}"
            if stats and t.is_floating_point():
                x = t.float()
                line += (f"  min={x.min().item():.4g} max={x.max().item():.4g} "
                         f"mean={x.mean().item():.4g} "
                         f"std={x.std(correction=0).item():.4g}")
            print(line)
    print(f"-- {total_params:,} params, {total_bytes / 2**20:.1f} MiB")


if __name__ == "__main__":
    main()
