"""Reward-model interfaces (port of ``vision_pt_tpu/reward/utils.py``).

A reward takes decoded images (NHWC, [-1, 1]) and their prompts and returns
one differentiable score a sample, so DRaFT+ backpropagates it through the
sampler's truncated tail. A reward tower is frozen: its parameters take no
gradient (``requires_grad_(False)``, the JAX package's ``FrozenRewardParam``)
and sit in no trainable tree, while gradients still flow through it to the
pixels.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Literal

import torch
from pydantic import BaseModel
from torch import nn


def freeze_reward_params(module: nn.Module) -> int:
    """Every parameter of ``module`` frozen; returns how many."""
    params = list(module.parameters())
    for p in params:
        p.requires_grad_(False)
    return len(params)


class RewardModelMixin(ABC):
    @abstractmethod
    def __call__(self, images: torch.Tensor, prompts: list[str]) -> torch.Tensor:
        """images (B, H, W, 3) in [-1, 1] -> scores (B,), differentiable."""


class RewardModelConfig(BaseModel, ABC):
    type: str

    @abstractmethod
    def load_model(self, device: str | torch.device | None = None) -> RewardModelMixin:
        """The reward, its towers (if any) on ``device`` (the CUDA device
        when None)."""


class CallableRewardModel(RewardModelMixin):
    """Any differentiable (images, prompts) -> scores function."""

    def __init__(self, fn: Callable[[torch.Tensor, list[str]], torch.Tensor]):
        self._fn = fn

    def __call__(self, images: torch.Tensor, prompts: list[str]) -> torch.Tensor:
        return self._fn(images, prompts)


class BrightnessRewardConfig(RewardModelConfig):
    """A toy differentiable reward, the mean brightness (smoke tests)."""

    type: Literal["brightness"] = "brightness"

    def load_model(self, device=None) -> RewardModelMixin:
        return CallableRewardModel(lambda images, prompts: images.mean(dim=(1, 2, 3)))
