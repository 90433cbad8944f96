from .callbacks import (
    DiscordPreviewCallbackConfig,
    LocalPreviewCallback,
    LocalPreviewCallbackConfig,
    PreviewCallback,
    PreviewCallbackConfigAlias,
    get_preview_callback,
)
from .strategy import PreviewStrategy, PreviewStrategyConfig

__all__ = [
    "PreviewStrategy",
    "PreviewStrategyConfig",
    "PreviewCallback",
    "LocalPreviewCallback",
    "LocalPreviewCallbackConfig",
    "DiscordPreviewCallbackConfig",
    "PreviewCallbackConfigAlias",
    "get_preview_callback",
]
