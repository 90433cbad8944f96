"""Preview callbacks (port of ``vision_pt_tpu/preview/callbacks.py``).
Posting to a Discord webhook needs the network and is not ported."""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import Literal, Union

from PIL import Image
from pydantic import BaseModel


class PreviewCallbackConfig(BaseModel):
    type: str
    save_dir: str


class LocalPreviewCallbackConfig(PreviewCallbackConfig):
    type: Literal["local"] = "local"


class DiscordPreviewCallbackConfig(PreviewCallbackConfig):
    type: Literal["discord"] = "discord"
    webhook_url: str = ""


PreviewCallbackConfigAlias = Union[
    LocalPreviewCallbackConfig, DiscordPreviewCallbackConfig
]


class PreviewCallback(ABC):
    save_name_template: str = "{epoch:05}e_{steps:06}s_{id:03}.webp"

    def __init__(self, save_dir: str | Path, save_name_template: str | None = None):
        self._save_dir = Path(save_dir)
        if save_name_template is not None:
            self.save_name_template = save_name_template

    def get_save_path(self, epoch: int, steps: int, index: int) -> Path:
        return self._save_dir / self.save_name_template.format(
            epoch=epoch, steps=steps, id=index
        )

    @abstractmethod
    def preview(self, images: list[Image.Image], epoch: int, steps: int,
                preview_index: int) -> None:
        ...


class LocalPreviewCallback(PreviewCallback):
    """Write preview images to disk."""

    def preview(self, images, epoch, steps, preview_index) -> None:
        for i, img in enumerate(images):
            path = self.get_save_path(epoch, steps, preview_index + i)
            path.parent.mkdir(parents=True, exist_ok=True)
            img.save(path)


def get_preview_callback(config: PreviewCallbackConfig) -> PreviewCallback:
    kwargs = config.model_dump()
    kind = kwargs.pop("type")
    if kind == "local":
        return LocalPreviewCallback(**kwargs)
    if kind == "discord":
        raise NotImplementedError(
            "the discord preview callback needs the network and is out of "
            "the port's scope"
        )
    raise ValueError(f"Unknown preview callback type: {kind}")
