"""Exponential moving average of the trainable parameters (port of
``vision_pt_tpu/training/ema.py``).

The EMA is a dict of tensors beside the module, keyed by parameter name,
updated in place after each applied optimizer update; saving swaps it into
the module and writes it under an ``ema_`` file name.
"""

from __future__ import annotations

import torch
from torch import nn


def _trainable(module: nn.Module):
    return ((name, p) for name, p in module.named_parameters() if p.requires_grad)


@torch.no_grad()
def init_ema(module: nn.Module) -> dict[str, torch.Tensor]:
    """A copy of the current trainable parameters."""
    return {name: p.detach().clone() for name, p in _trainable(module)}


@torch.no_grad()
def update_ema(ema: dict[str, torch.Tensor], module: nn.Module,
               decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * param, in place."""
    for name, p in _trainable(module):
        e = ema[name]
        e.copy_(e * decay + p.to(e.dtype) * (1.0 - decay))


@torch.no_grad()
def swap_in_ema_params(module: nn.Module,
                       ema: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Copy the EMA into the module's parameters; return the originals,
    which :func:`restore_params` puts back."""
    original = {}
    for name, p in _trainable(module):
        original[name] = p.detach().clone()
        p.copy_(ema[name])
    return original


@torch.no_grad()
def restore_params(module: nn.Module, params: dict[str, torch.Tensor]) -> None:
    for name, p in _trainable(module):
        p.copy_(params[name])
