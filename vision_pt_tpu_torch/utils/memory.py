"""Device-memory introspection (port of ``vision_pt_tpu/utils/memory.py``).

The JAX package records XLA's static memory analysis of a compiled program,
because its chip exposes no runtime statistics. PyTorch compiles nothing
ahead of time, so :func:`compiled_memory_analysis` here is a **measured**
peak: the allocator's peak statistic is reset, the callable runs once and
the new peak is read. The keys that still mean something are kept; the
number is what this run allocated, not a compile-time bound.
"""

from __future__ import annotations

from typing import Any

import torch


def live_peak_bytes(device: int | torch.device | None = None) -> int | None:
    """The CUDA allocator's peak since the last reset, or ``None`` without
    a card."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.max_memory_allocated(device))


def compiled_memory_analysis(fn, *args, **kwargs) -> dict[str, int] | None:
    """Run ``fn(*args, **kwargs)`` once and measure it: ``argument_bytes``
    (the tensors among the arguments), ``output_bytes`` (the tensors it
    returns), ``temp_bytes`` (the peak above what was allocated before the
    call, less the outputs), ``alias_bytes`` (outputs that share storage
    with an argument) and ``total_bytes`` = argument + output + temp - alias.
    On a CUDA device the peak is the allocator's; on the CPU, which keeps no
    peak, ``temp_bytes`` is 0 and the total counts arguments and outputs.
    ``None`` when the call raises."""
    tensors = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
    cuda = any(t.is_cuda for t in tensors)
    try:
        if cuda:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        out = fn(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
    except Exception:
        return None
    outputs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
               if isinstance(o, torch.Tensor)]
    arg = sum(t.nbytes for t in tensors)
    output = sum(o.nbytes for o in outputs)
    pointers = {t.untyped_storage().data_ptr() for t in tensors}
    alias = sum(o.nbytes for o in outputs if o.untyped_storage().data_ptr() in pointers)
    temp = max(peak - before - (output - alias), 0) if cuda else 0
    return {"argument_bytes": arg, "output_bytes": output, "temp_bytes": temp,
            "alias_bytes": alias, "total_bytes": arg + output + temp - alias}


def format_bytes(n: int | None) -> str:
    if n is None:
        return "n/a"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024:
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} TiB"


def peak_hbm_record(fn=None, *args: Any, **kwargs: Any) -> dict:
    """The allocator's peak, and with ``fn`` the measured analysis of one
    call of ``fn`` at ``args``."""
    record: dict[str, Any] = {"live_peak_bytes": live_peak_bytes()}
    if fn is not None:
        record["static"] = compiled_memory_analysis(fn, *args, **kwargs)
    return record
