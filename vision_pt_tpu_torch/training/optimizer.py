"""Optimizer factory (port of ``vision_pt_tpu/training/optimizer.py``).

The same config names as the JAX package: torch, bitsandbytes and
schedule-free dotted names resolve through one alias table. ``adamw`` is
``torch.optim.AdamW`` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
weight_decay 1e-4), not torch's (weight_decay 1e-2); ``adam`` and ``sgd``
are torch's with optax's defaults. The learning rate is set by the Trainer
before every step from the schedule (see ``scheduler.py``), except for
schedule-free, which takes the schedule itself, as optax does.

The JAX package maps both ``schedulefree.AdamWScheduleFree`` and
``RAdamScheduleFree`` to ``optax.contrib.schedule_free_adamw``, so the port
implements that update (:class:`ScheduleFreeAdamW`), not the
``schedulefree`` library's. ``bitsandbytes.optim.AdamW8bit`` /
``Adam8bit`` are ``optim8bit``'s int8-moment Adam. ``prodigy``, ``lion``
(and the bitsandbytes Lion names), ``adafactor``, ``rmsprop`` and ``adagrad``
are the optax rules the JAX package builds, in ``optax_optimizers``.
``came`` maps onto ``optax.contrib.came``, which the optax the JAX package
runs against (0.2.6) does not have, so it raises there and here.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..parallel.mesh import _local

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


# the optax rules of ``optax_optimizers``, by the JAX package's name
_OPTAX = {"prodigy": "Prodigy", "lion": "Lion", "adafactor": "Adafactor",
          "rmsprop": "RMSprop", "adagrad": "Adagrad"}


def _translate_args(args: dict) -> dict:
    """torch-style argument names: ``learning_rate`` -> ``lr``,
    optax's ``b1``/``b2`` -> ``betas``."""
    out = dict(args)
    if "learning_rate" in out:
        out["lr"] = out.pop("learning_rate")
    if "b1" in out or "b2" in out:
        out["betas"] = (out.pop("b1", 0.9), out.pop("b2", 0.999))
    return out


class StateKeepsDtype:
    """``load_state_dict`` that restores every state tensor in its own dtype:
    torch's casts floating state to the parameter's dtype, and nothing here
    may change dtype (int8 moments, fp32 scales beside bf16 parameters)."""

    def load_state_dict(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)
        params = [p for group in self.param_groups for p in group["params"]]
        for index, saved in state_dict["state"].items():
            # state shared by every parameter sits under a name, on the
            # first parameter's device
            p = params[index] if isinstance(index, int) else params[0]
            self.state[p if isinstance(index, int) else index] = {
                k: v.to(p.device, copy=True) if isinstance(v, torch.Tensor) else v
                for k, v in saved.items()}


def warmup_constant(peak: float, warmup_steps: int) -> Callable[[int], float]:
    """``optax.warmup_constant_schedule(0, peak, warmup_steps)``: linear from
    0 to ``peak`` over ``warmup_steps`` counts, then ``peak``, in fp32."""
    v, w = np.float32(peak), np.float32(warmup_steps)

    def schedule(count: int) -> float:
        if count >= warmup_steps:
            return float(peak)
        return float(-v * (np.float32(1) - np.float32(count) / w) + v)

    return schedule


class ScheduleFreeAdamW(StateKeepsDtype, torch.optim.Optimizer):
    """``optax.contrib.schedule_free_adamw``: AdamW without momentum
    (``scale_by_rms`` with bias correction, eps outside the root, decoupled
    weight decay, the rate) moves the z sequence; the parameters hold
    y = b1 x + (1 - b1) z, where x averages z with weights max_lr^power.
    :meth:`eval_params` gives x. The rate is ``lr`` (with a linear warmup
    over ``warmup_steps``) or ``lr_schedule``: update n moves z at
    schedule(n) and weighs the average at schedule(n + 1), optax's two
    counts. The state sits in the parameters' dtype, as optax keeps it."""

    def __init__(self, params, lr: float = 0.0025, warmup_steps: int | None = None,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, weight_lr_power: float = 2.0,
                 lr_schedule: Callable[[int], float] | None = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay,
                                      weight_lr_power=weight_lr_power))
        if lr_schedule is not None and warmup_steps:
            raise ValueError("schedule-free warmup_steps with the Trainer's schedule: "
                             "put the warmup in the scheduler config")
        if lr_schedule is None:
            lr_schedule = (warmup_constant(lr, warmup_steps) if warmup_steps
                           else lambda count: lr)
        self.schedule = lr_schedule

    def _state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            zero = torch.zeros((), dtype=p.dtype, device=p.device)
            state.update(z=p.detach().clone(), nu=torch.zeros_like(p),
                         step_count=1, weight_sum=zero, max_lr=zero.clone())
        return state

    @torch.no_grad()
    def step(self, closure=None):
        # elementwise: a sharded parameter (a DTensor) updates its own shard,
        # its z and nu sharded alike
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for param in group["params"]:
                if param.grad is None:
                    continue
                state = self._state(param)
                n = state["step_count"]
                p, g = _local(param), _local(param.grad)
                # the base transform: rms scaling, decay, the rate at count n - 1
                nu = _local(state["nu"])
                nu.copy_((1 - b2) * g**2 + b2 * nu)
                bias = float(np.float32(1) - np.float32(b2) ** np.float32(n))
                nu_hat = nu / torch.tensor(bias, dtype=nu.dtype)
                u = g * (1 / (torch.sqrt(nu_hat) + group["eps"]))
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                u = u * torch.tensor(-self.schedule(n - 1), dtype=u.dtype)
                z_old = _local(state["z"])
                z = (z_old + u).to(z_old.dtype)
                # the average's weight from the rate at count n
                lr = torch.tensor(self.schedule(n), dtype=state["max_lr"].dtype)
                max_lr = torch.maximum(state["max_lr"], lr)
                weight = max_lr ** group["weight_lr_power"]
                total = state["weight_sum"] + weight
                ck = torch.nan_to_num(weight / total, nan=0.0, posinf=math.inf)
                prev_x = (p - (1.0 - b1) * z_old) / b1
                x = (1.0 - ck) * prev_x + ck * z
                new_p = b1 * x + (1.0 - b1) * z
                p.copy_(p + (new_p - p))
                z_old.copy_(z)
                state.update(step_count=n + 1, weight_sum=total, max_lr=max_lr)

    @torch.no_grad()
    def eval_params(self) -> dict[torch.Tensor, torch.Tensor]:
        """x = (y - (1 - b1) z) / b1 for every parameter with state
        (``optax.contrib.schedule_free_eval_params``)."""
        out = {}
        for group in self.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                if self.state[p]:
                    out[p] = (p - (1.0 - b1) * self.state[p]["z"]) / b1
        return out


def is_schedule_free(name: str) -> bool:
    """Schedule-free optimizers train on y; previews and saves use x."""
    return "schedulefree" in name.lower() or "schedule_free" in name.lower()


def resolve_name(name: str) -> str:
    """The JAX package's optimizer name for a config name."""
    key = _ALIASES.get(name.lower(), name.lower())
    return key.removeprefix("optax.contrib.").removeprefix("optax.")


def get_optimizer(name: str, params, args: dict | None = None,
                  lr: float = 1e-3,
                  lr_schedule: Callable[[int], float] | None = None,
                  layouts: dict | None = None) -> torch.optim.Optimizer:
    """A torch optimizer over ``params`` for a config name. ``lr`` is the
    initial rate; the Trainer overwrites it before each step, except for
    schedule-free, which follows ``lr_schedule`` when given. ``layouts``
    ({parameter: the dims of the JAX package's layout}) sets the order the
    8-bit moments' blocks run in."""
    args = _translate_args(dict(args or {}))
    args["lr"] = args.get("lr", lr)
    key = resolve_name(name)
    if key in ("schedule_free_adamw", "schedule_free_radam"):
        return ScheduleFreeAdamW(params, lr_schedule=lr_schedule, **args)
    if key in ("adamw8bit", "adam8bit"):
        from .optim8bit import Adam8bit, AdamW8bit

        return (AdamW8bit if key == "adamw8bit" else Adam8bit)(params, layouts=layouts,
                                                               **args)
    if key == "adamw":
        args.setdefault("weight_decay", 1e-4)
        args.setdefault("eps", 1e-8)
        return torch.optim.AdamW(params, **args)
    if key == "adam":
        args.setdefault("eps", 1e-8)
        return torch.optim.Adam(params, **args)
    if key == "sgd":
        return torch.optim.SGD(params, **args)
    if key in _OPTAX:
        from . import optax_optimizers

        return getattr(optax_optimizers, _OPTAX[key])(params, **args)
    if key == "came":
        raise ValueError("optax.contrib.came not available in this optax")
    raise ValueError(f"Unknown optimizer: {name}")
