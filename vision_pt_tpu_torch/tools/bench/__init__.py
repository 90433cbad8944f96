"""The attention probes of ``tools/bench`` on the card (kernels #10 and #11),
and the timing they share.

    python -m vision_pt_tpu_torch.tools.bench.attention_pairing_probe
    python -m vision_pt_tpu_torch.tools.bench.attention_roofline
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from ...ops import _build
from .timing import (  # noqa: F401  (the probes' and chip_smoke's timing)
    cuda_ms,
    device_timing,
    event_ms,
    launches_of_timing,
)


def probe_kernel(entry: str, argtypes: list):
    """The C entry ``entry`` of ``csrc/attention_probe.cu``, built and bound
    at first use; it returns 0 or an error code."""
    fn = getattr(_build.load("attention_probe"), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def card() -> dict:
    """The card that ran: its name, and its name and power limit as
    ``nvidia-smi`` prints them. Raises without a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the probes run on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
