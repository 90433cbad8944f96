"""Learning-rate schedules (port of ``vision_pt_tpu/training/scheduler.py``).

``get_lr_schedule`` returns a plain ``step -> lr`` function with optax's
formulas. As in optax, the rate of optimizer update ``n`` (counting from 1)
is ``schedule(n - 1)``: the schedule is read at the count of updates already
applied. The Trainer keeps that count and sets the rate before each step.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def nothing_schedule(base_lr: float) -> Schedule:
    """A constant rate."""
    return lambda step: base_lr


def _polynomial(init: float, end: float, power: float, steps: int,
                begin: int = 0) -> Schedule:
    """optax.polynomial_schedule: ``init`` until ``begin``, then
    ``(init - end) * (1 - t / steps) ** power + end``, then ``end``."""
    if steps <= 0:
        return lambda step: init

    def fn(step):
        t = min(max(step - begin, 0), steps)
        return (init - end) * (1 - t / steps) ** power + end

    return fn


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules with one boundary."""
    return lambda step: first(step) if step < boundary else second(step - boundary)


def _cosine_decay(init: float, steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    if steps <= 0:
        raise ValueError(f"cosine decay needs positive decay steps, got {steps}")

    def fn(step):
        t = min(step, steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / steps)) + alpha)

    return fn


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear warmup from ``init_value``
    to ``peak_value``, then cosine decay to ``end_value`` at ``decay_steps``
    (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return _join(
        _polynomial(init_value, peak_value, 1.0, warmup_steps),
        _cosine_decay(peak_value, decay_steps - warmup_steps, alpha),
        warmup_steps,
    )


def get_lr_schedule(base_lr: float, name: str | None = None,
                    args: dict | None = None,
                    total_steps: int | None = None) -> Schedule:
    """transformers-style names, as the JAX package takes them; a missing
    name means a constant rate."""
    args = dict(args or {})
    if name is None or name in ("nothing", "NothingScheduler", "constant"):
        return nothing_schedule(base_lr)

    warmup = int(args.pop("num_warmup_steps", args.pop("warmup_steps", 0)))
    steps = int(
        args.pop("num_training_steps", args.pop("decay_steps", total_steps or 0))
    )
    key = name.lower()
    if key == "constant_with_warmup":
        warm = max(warmup, 1)
        return _join(_polynomial(0.0, base_lr, 1.0, warm), nothing_schedule(base_lr),
                     warm)
    if key == "linear":
        return _warmup_linear(base_lr, warmup, steps)
    if key == "cosine":
        return warmup_cosine_decay_schedule(0.0, base_lr, max(warmup, 0),
                                            max(steps, 1))
    if key == "cosine_with_restarts":
        cycles = args.pop("num_cycles", 1)
        return _warmup_cosine_restarts(base_lr, warmup, steps, cycles)
    if key == "polynomial":
        power = args.pop("power", 1.0)
        end = args.pop("lr_end", 1e-7)
        return _polynomial(base_lr, end, power, max(steps, 1), warmup)
    raise ValueError(
        f"Unknown scheduler: {name} (optax schedules by name are not ported)"
    )


def _warmup_linear(base_lr: float, warmup: int, total: int) -> Schedule:
    def fn(step):
        if step < warmup:
            return base_lr * min(step / max(warmup, 1), 1.0)
        if total <= 0:
            return base_lr
        return base_lr * max((total - step) / max(total - warmup, 1), 0.0)

    return fn


def _warmup_cosine_restarts(base_lr: float, warmup: int, total: int,
                            cycles: int) -> Schedule:
    def fn(step):
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        progress = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * max(
            0.0, 0.5 * (1.0 + math.cos(math.pi * ((cycles * progress) % 1.0)))
        )

    return fn
