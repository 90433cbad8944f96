"""Reward model loading (port of ``vision_pt_tpu/reward/functional.py``)."""

from __future__ import annotations

from .pickscore import PickScoreConfig
from .utils import BrightnessRewardConfig, RewardModelConfig, RewardModelMixin

_REWARD_CONFIGS = {
    "pickscore": PickScoreConfig,
    "brightness": BrightnessRewardConfig,
}


def resolve_reward_config(config) -> RewardModelConfig:
    if isinstance(config, RewardModelConfig):
        return config
    return _REWARD_CONFIGS[config["type"]].model_validate(config)


def load_reward_models(configs, device=None) -> list[RewardModelMixin]:
    """Each config's reward, its towers on ``device``."""
    return [resolve_reward_config(c).load_model(device) for c in configs]
