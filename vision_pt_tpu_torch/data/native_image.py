"""ctypes wrapper of the C image loader (port of
``vision_pt_tpu/data/native_image.py``): decode, cover-resize and crop in
one C call over ``native/image_loader.cpp``, with libjpeg's DCT-scaled
decoding (a large JPEG headed for a small bucket decodes at a reduced
scale).

The loader is built at first use by ``g++ -O3 -fPIC -shared -std=c++17
... -ljpeg -lpng -lwebp`` (the libjpeg, libpng and libwebp headers must be
installed) into ``vision_pt_tpu_torch/csrc/build/``, under a name that
hashes the source, as the CUDA kernels are. Where it cannot be built or
loaded, every call returns None and the datasets decode through PIL, as
the JAX package's do where its loader is absent; :func:`build_error` says
why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "image_loader.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lwebp")
_SUPPORTED = (".jpg", ".jpeg", ".png", ".webp")

_lock = threading.Lock()
_lib = None
_error: str | None = None


def library_path() -> Path:
    """The built loader's path: ``libimage_loader-<source hash>.so``."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libimage_loader-{digest}.so"


def build() -> Path:
    """Compile the loader unless its library exists; raise on failure."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exit {out.returncode}: {out.stderr.strip()}")
    os.replace(tmp, so)  # atomic: concurrent builds leave one library
    return so


def _get_lib():
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        c_int_p = ctypes.POINTER(ctypes.c_int)
        lib.vptpu_probe.argtypes = [ctypes.c_char_p, c_int_p, c_int_p]
        lib.vptpu_probe.restype = ctypes.c_int
        lib.vptpu_cover_dims.argtypes = [ctypes.c_int] * 4 + [c_int_p, c_int_p]
        lib.vptpu_cover_dims.restype = None
        lib.vptpu_load_cover_crop.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_uint8)]
        lib.vptpu_load_cover_crop.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


def build_error() -> str | None:
    """Why the loader could not be built or loaded (None if it was)."""
    _get_lib()
    return _error


def supports(path: str | Path) -> bool:
    return str(path).lower().endswith(_SUPPORTED)


def probe_size(path: str | Path) -> tuple[int, int] | None:
    """(width, height) from the header; None if unsupported."""
    lib = _get_lib()
    if lib is None or not supports(path):
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.vptpu_probe(str(path).encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def cover_dims(src_w: int, src_h: int, target_w: int, target_h: int) -> tuple[int, int]:
    """The cover-resize size, the C side's arithmetic (and
    ``ObjectCoverResize``'s)."""
    scale = max(target_w / src_w, target_h / src_h)
    return (max(int(round(src_w * scale)), target_w),
            max(int(round(src_h * scale)), target_h))


def load_cover_crop(path: str | Path, target_w: int, target_h: int, crop_x: int,
                    crop_y: int) -> np.ndarray | None:
    """The decoded, cover-resized and cropped RGB8 (target_h, target_w, 3),
    or None where the loader cannot read the file (the caller then takes
    PIL)."""
    lib = _get_lib()
    if lib is None or not supports(path):
        return None
    out = np.empty((target_h, target_w, 3), dtype=np.uint8)
    rc = lib.vptpu_load_cover_crop(str(path).encode(), target_w, target_h, crop_x, crop_y,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None
