"""Image transforms of the class-image, text-image and referenced datasets
and of the image-conditioned pipelines (the port's own copy of the part of
``vision_pt_tpu/data/transforms.py`` they use), PIL + NumPy. Images flow as
NumPy float32 HWC in [-1, 1]."""

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


class ObjectCoverResize:
    """CSS ``object-fit: cover``: scale (bicubic) to cover (width, height),
    keeping the aspect; without ``do_upscale`` a smaller image keeps its
    size. The crop to the exact size follows."""

    def __init__(self, width: int, height: int, do_upscale: bool = True):
        self.width = width
        self.height = height
        self.do_upscale = do_upscale

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        scale = max(self.width / w, self.height / h)
        if scale > 1.0 and not self.do_upscale:
            scale = 1.0
        new_w = max(self.width, int(round(w * scale)))
        new_h = max(self.height, int(round(h * scale)))
        return img.resize((new_w, new_h), Image.Resampling.BICUBIC)


def random_crop(arr: np.ndarray, height: int, width: int,
                rng: np.random.Generator) -> tuple[np.ndarray, tuple[int, int]]:
    """A random (height, width) crop and its (top, left), for SDXL's size
    conditioning."""
    h, w = arr.shape[:2]
    top = int(rng.integers(0, max(h - height, 0) + 1))
    left = int(rng.integers(0, max(w - width, 0) + 1))
    return arr[top : top + height, left : left + width], (top, left)


class PaddedResize:
    """Letterbox to a ``max_size`` square: scale the long side to it
    (bicubic) and centre the image on a ``fill`` background."""

    def __init__(self, max_size: int, fill: int = 255):
        self.max_size = max_size
        self.fill = fill

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        scale = self.max_size / max(w, h)
        new_w, new_h = int(round(w * scale)), int(round(h * scale))
        img = img.resize((new_w, new_h), Image.Resampling.BICUBIC)
        canvas = Image.new("RGB", (self.max_size, self.max_size),
                           (self.fill, self.fill, self.fill))
        canvas.paste(img, ((self.max_size - new_w) // 2, (self.max_size - new_h) // 2))
        return canvas


class ColorChannelSwap:
    """Reorder the channels of an HWC array (RGB <-> BGR by default)."""

    def __init__(self, swap: tuple[int, int, int] = (2, 1, 0)):
        self.swap = swap

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return arr[..., list(self.swap)]
