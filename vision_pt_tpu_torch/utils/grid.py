"""Preview image grid (port of ``vision_pt_tpu/utils/grid.py``)."""

from __future__ import annotations

import math

import numpy as np
from PIL import Image


def images_to_grid_image(images: list[Image.Image], padding: int = 2,
                         fill: int = 0) -> Image.Image:
    """Tile images into a roughly square grid, ``ncol`` = floor(sqrt(n)),
    each cell the largest image's size plus ``padding``."""
    n = len(images)
    assert n > 0
    ncol = max(int(n ** 0.5), 1)
    nrow = math.ceil(n / ncol)
    w = max(img.width for img in images)
    h = max(img.height for img in images)
    canvas = np.full(
        (nrow * (h + padding) + padding, ncol * (w + padding) + padding, 3),
        fill, dtype=np.uint8,
    )
    for i, img in enumerate(images):
        r, c = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = c * (w + padding) + padding
        arr = np.asarray(img.convert("RGB"))
        canvas[y:y + arr.shape[0], x:x + arr.shape[1]] = arr
    return Image.fromarray(canvas)
