"""safetensors loading helpers (port of ``vision_pt_tpu/utils/safetensors.py``)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_file_with_rename_key_map(
    file_path: str | Path, rename_key_map: dict[str, str]
) -> dict[str, np.ndarray]:
    """Load a file and apply each rename to the first occurrence of its
    prefix in every key, in the map's order."""
    from safetensors.numpy import load_file

    state_dict = load_file(str(file_path))

    def replace(key: str) -> str:
        for prefix, to in rename_key_map.items():
            key = key.replace(prefix, to, 1)
        return key

    return {replace(k): v for k, v in state_dict.items()}
