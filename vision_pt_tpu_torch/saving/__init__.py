from .callbacks import (
    HFHubSavingCallbackConfig,
    ModelSavingCallback,
    ModelSavingCallbackConfig,
    ModelSavingCallbackConfigAlias,
    SafetensorsSavingCallback,
    SafetensorsSavingCallbackConfig,
    get_saving_callback,
)
from .strategy import ModelSavingStrategy, ModelSavingStrategyConfig

__all__ = [
    "ModelSavingStrategy",
    "ModelSavingStrategyConfig",
    "ModelSavingCallback",
    "ModelSavingCallbackConfig",
    "SafetensorsSavingCallback",
    "SafetensorsSavingCallbackConfig",
    "HFHubSavingCallbackConfig",
    "get_saving_callback",
    "ModelSavingCallbackConfigAlias",
]
