"""Image transforms of the class-image dataset (the port's own copy of the
part of ``vision_pt_tpu/data/transforms.py`` it uses), PIL + NumPy. Images
flow as NumPy float32 HWC in [-1, 1]."""

from __future__ import annotations

import numpy as np
from PIL import Image


def to_array(img: Image.Image) -> np.ndarray:
    """PIL RGB -> HWC float32 in [-1, 1]."""
    arr = np.asarray(img.convert("RGB"), dtype=np.float32)
    return arr / 127.5 - 1.0


def center_crop(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = (h - height) // 2
    left = (w - width) // 2
    return arr[top : top + height, left : left + width]


def resize_max_side(img: Image.Image, max_size: int) -> Image.Image:
    """Resize so the SHORT side is ``max_size`` (bicubic); a center crop to
    the square follows."""
    w, h = img.size
    scale = max_size / min(w, h)
    return img.resize(
        (int(round(w * scale)), int(round(h * scale))), Image.Resampling.BICUBIC
    )
