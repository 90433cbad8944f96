"""The attention probes of ``tools/bench`` on the card (kernels #10 and #11),
and the timing they share.

    python -m vision_pt_tpu_torch.tools.bench.attention_pairing_probe
    python -m vision_pt_tpu_torch.tools.bench.attention_roofline
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import Callable

import torch

from ...ops import _build

def probe_kernel(entry: str, argtypes: list):
    """The C entry ``entry`` of ``csrc/attention_probe.cu``, built and bound
    at first use; it returns 0 or an error code."""
    fn = getattr(_build.load("attention_probe"), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def cuda_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> float:
    """Mean device ms per call over ``iters`` back-to-back calls of ``fn`` on
    the current stream (each waits for the one before), timed with CUDA
    events after ``warmup`` calls. The one timing convention of the probes
    and ``chip_smoke.py``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launches_of_timing(iters: int, warmup: int = 3) -> int:
    """Kernel launches :func:`cuda_ms` makes of a ``fn`` that launches one."""
    return warmup + iters


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
