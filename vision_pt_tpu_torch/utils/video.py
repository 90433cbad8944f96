"""Images to video (port of ``vision_pt_tpu/utils/video.py``)."""

from __future__ import annotations

import os
from typing import Literal

import numpy as np
from PIL import Image


def write_images_as_video(
    images: list[Image.Image],
    output_path: str,
    fps: int,
    codec: Literal["mp4v", "h264", "avc1"] = "mp4v",
) -> str:
    """Write ``images`` with OpenCV's VideoWriter and return the path
    written. When the writer does not open, or opens and writes nothing
    (its ffmpeg backend can), an animated GIF goes beside the requested
    path instead and that path is returned. ``cv2`` is imported here, so the
    module imports without it."""
    import cv2

    width, height = images[0].size
    fourcc = cv2.VideoWriter.fourcc(*codec)
    writer = cv2.VideoWriter(output_path, fourcc, fps, (width, height))
    if writer.isOpened():
        try:
            for img in images:
                frame = np.asarray(img.convert("RGB"))
                writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        finally:
            writer.release()
        if os.path.exists(output_path) and os.path.getsize(output_path) > 0:
            return output_path

    gif_path = os.path.splitext(output_path)[0] + ".gif"
    frames = [img.convert("RGB") for img in images]
    frames[0].save(
        gif_path, save_all=True, append_images=frames[1:],
        duration=max(1, int(1000 / fps)), loop=0,
    )
    return gif_path
