"""The timing of the kernel and library columns: device time only.

Loaded by path as well as imported (``kernel_ab`` times another tree's
kernels with it), so it imports nothing of the package.
"""

from __future__ import annotations

import statistics
from typing import Callable, NamedTuple

import torch

WINDOWS = 5  # timing windows of device_timing


class Timing(NamedTuple):
    """Device ms per call: the median over the windows, the smallest and the
    largest window, the number of windows that recorded device activity,
    and the median window's ms per call of each device kernel by name."""

    median: float
    low: float
    high: float
    windows: int
    by_kernel: dict


def device_timing(fn: Callable[[], object], iters: int, warmup: int = 3,
                  windows: int = WINDOWS) -> Timing:
    """Device ms per call of ``fn``, host time excluded: after ``warmup``
    calls, ``windows`` windows of ``iters`` back-to-back calls, each under
    its own ``torch.profiler`` session and closed by a synchronize. A
    window's time per call is, over the device activities it recorded
    (kernels, copies, fills) grouped by name, the mean duration of each
    times the number of its launches a call (its count over ``iters``,
    rounded): the profiler can drop a few records of a session, which this
    absorbs, and launches made less than once a call count for nothing. A
    window in which the profiler recorded no device activity at all (seen
    on the card, rarely) is left out, not run again, so that the calls made
    stay :func:`launches_of_timing`; it raises if every window is empty. The
    kernel and library columns of ``chip_smoke.py`` and of the probes are
    timed so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_window = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        records: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                records.setdefault(e.name, []).append(e.time_range.elapsed_us())
        by_kernel = {name: round(len(us) / iters) * sum(us) / len(us) / 1e3
                     for name, us in records.items() if round(len(us) / iters)}
        if by_kernel:
            per_window.append((sum(by_kernel.values()), by_kernel))
    if not per_window:
        raise RuntimeError("no device activity recorded in any timing window")
    per_window.sort(key=lambda w: w[0])
    ms = [w[0] for w in per_window]
    return Timing(statistics.median(ms), ms[0], ms[-1], len(per_window),
                  per_window[len(per_window) // 2][1])


def cuda_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> float:
    """The median of :func:`device_timing`: device ms per call."""
    return device_timing(fn, iters, warmup).median


def event_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> float:
    """Mean ms per call over one window of ``iters`` back-to-back calls on
    the current stream, timed with CUDA events after ``warmup`` calls: host
    launch time included where it exceeds the device's. ``chip_smoke.py``
    times the plain versions so."""
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
    return warmup + WINDOWS * iters
