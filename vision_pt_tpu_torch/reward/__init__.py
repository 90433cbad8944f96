"""Reward models for reward-guided fine-tuning (port of
``vision_pt_tpu/reward/``)."""

from .functional import load_reward_models, resolve_reward_config
from .pickscore import PickScoreConfig, PickScoreRewardModel
from .utils import (
    BrightnessRewardConfig,
    CallableRewardModel,
    RewardModelConfig,
    RewardModelMixin,
)

__all__ = [
    "BrightnessRewardConfig",
    "CallableRewardModel",
    "PickScoreConfig",
    "PickScoreRewardModel",
    "RewardModelConfig",
    "RewardModelMixin",
    "load_reward_models",
    "resolve_reward_config",
]
