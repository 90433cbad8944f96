"""Optimizer factory (port of ``vision_pt_tpu/training/optimizer.py``).

The same config names as the JAX package: torch, bitsandbytes and
schedule-free dotted names resolve through one alias table. ``adamw`` is
``torch.optim.AdamW`` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
weight_decay 1e-4), not torch's (weight_decay 1e-2); ``adam`` and ``sgd``
are torch's with optax's defaults. The learning rate is set by the Trainer
before every step from the schedule (see ``scheduler.py``).
"""

from __future__ import annotations

import torch

# torch / bitsandbytes / schedule-free name -> the JAX package's optimizer name
_ALIASES: dict[str, str] = {
    "torch.optim.adamw": "adamw",
    "torch.optim.adam": "adam",
    "torch.optim.sgd": "sgd",
    "torch.optim.rmsprop": "rmsprop",
    "torch.optim.adagrad": "adagrad",
    "torch.optim.adafactor": "adafactor",
    "bitsandbytes.optim.adamw8bit": "adamw8bit",
    "bitsandbytes.optim.adam8bit": "adam8bit",
    "bitsandbytes.optim.lion8bit": "lion",
    "bitsandbytes.optim.lion": "lion",
    "schedulefree.adamwschedulefree": "schedule_free_adamw",
    "schedulefree.radamschedulefree": "schedule_free_radam",
    "transformers.optimization.adafactor": "adafactor",
    "came": "came",
    "lion": "lion",
    "prodigy": "prodigy",
}

_NOT_PORTED = {
    "schedule_free_adamw": "schedule-free",
    "schedule_free_radam": "schedule-free",
    "adamw8bit": "8-bit",
    "adam8bit": "8-bit",
    "prodigy": "prodigy",
    "came": "came",
    "lion": "lion",
    "adafactor": "adafactor",
    "rmsprop": "rmsprop",
    "adagrad": "adagrad",
}


def _translate_args(args: dict) -> dict:
    """torch-style argument names: ``learning_rate`` -> ``lr``,
    optax's ``b1``/``b2`` -> ``betas``."""
    out = dict(args)
    if "learning_rate" in out:
        out["lr"] = out.pop("learning_rate")
    if "b1" in out or "b2" in out:
        out["betas"] = (out.pop("b1", 0.9), out.pop("b2", 0.999))
    return out


def get_optimizer(name: str, params, args: dict | None = None,
                  lr: float = 1e-3) -> torch.optim.Optimizer:
    """A torch optimizer over ``params`` for a config name. ``lr`` is the
    initial rate; the Trainer overwrites it before each step."""
    args = _translate_args(dict(args or {}))
    args["lr"] = args.get("lr", lr)
    key = _ALIASES.get(name.lower(), name.lower())
    key = key.removeprefix("optax.contrib.").removeprefix("optax.")
    if key == "adamw":
        args.setdefault("weight_decay", 1e-4)
        args.setdefault("eps", 1e-8)
        return torch.optim.AdamW(params, **args)
    if key == "adam":
        args.setdefault("eps", 1e-8)
        return torch.optim.Adam(params, **args)
    if key == "sgd":
        return torch.optim.SGD(params, **args)
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} ({_NOT_PORTED[key]}) is not ported yet: "
            "ROADMAP Queue 1, slice 2 leftovers (the non-AdamW optimizers)"
        )
    raise ValueError(f"Unknown optimizer: {name}")
