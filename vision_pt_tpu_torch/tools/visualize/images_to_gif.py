"""Build a GIF from a folder of preview images (port of
``tools/visualize/images_to_gif.py``), frames in file-name order.

    python -m vision_pt_tpu_torch.tools.visualize.images_to_gif \\
        -i previews/ -o previews.gif --duration 200
"""

from __future__ import annotations

from pathlib import Path

import click
from PIL import Image

EXTENSIONS = (".png", ".webp", ".jpg", ".jpeg")


@click.command()
@click.option("--input", "-i", "input_dir", type=str, required=True)
@click.option("--output", "-o", "output_path", type=str, required=True)
@click.option("--duration", type=int, default=200, help="ms per frame")
@click.option("--loop", type=int, default=0)
@click.option("--max-size", type=int, default=None)
def main(input_dir: str, output_path: str, duration: int, loop: int,
         max_size: int | None):
    paths = sorted(
        p for p in Path(input_dir).iterdir()
        if p.suffix.lower() in EXTENSIONS
    )
    if not paths:
        raise SystemExit(f"no images found in {input_dir}")
    frames = []
    for p in paths:
        img = Image.open(p).convert("RGB")
        if max_size:
            img.thumbnail((max_size, max_size))
        frames.append(img)
    frames[0].save(
        output_path, save_all=True, append_images=frames[1:],
        duration=duration, loop=loop,
    )
    print(f"Wrote {len(frames)} frames to {output_path}")


if __name__ == "__main__":
    main()
