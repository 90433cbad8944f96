"""dtype string parsing (port of ``vision_pt_tpu/utils/dtype.py``)."""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "float": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
    "half": torch.float16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "fp8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
}


def str_to_dtype(name: str) -> torch.dtype:
    key = name.lower().removeprefix("torch.").removeprefix("jnp.")
    if key not in _DTYPES:
        raise ValueError(f"Unknown dtype string: {name}")
    return _DTYPES[key]

