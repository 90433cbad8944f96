"""Model saving callbacks (port of ``vision_pt_tpu/saving/callbacks.py``).

Callbacks receive the flat state dict in the reference checkpoint layout
(``JiTModel.state_dict``) and write it with the name template
``{name}_{epoch:05}e_{steps:06}s.safetensors``. Uploading to the Hugging Face
Hub needs the network and is not ported.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import Literal, Union

import torch
from pydantic import BaseModel


class ModelSavingCallbackConfig(BaseModel):
    type: str
    name: str
    save_dir: str


class SafetensorsSavingCallbackConfig(ModelSavingCallbackConfig):
    type: Literal["safetensors"] = "safetensors"


class HFHubSavingCallbackConfig(ModelSavingCallbackConfig):
    type: Literal["hf_hub"] = "hf_hub"
    repo_id: str = ""
    path_in_repo: str = ""
    private: bool = True


ModelSavingCallbackConfigAlias = Union[
    SafetensorsSavingCallbackConfig, HFHubSavingCallbackConfig
]


class ModelSavingCallback(ABC):
    save_name_template: str = "{name}_{epoch:05}e_{steps:06}s.safetensors"

    def __init__(self, name: str, save_dir: str | Path,
                 save_name_template: str | None = None):
        self.name = name
        self._save_dir = Path(save_dir)
        if save_name_template is not None:
            self.save_name_template = save_name_template

    def get_save_path(self, epoch: int, steps: int) -> Path:
        return self._save_dir / self.save_name_template.format(
            name=self.name, epoch=epoch, steps=steps
        )

    @abstractmethod
    def save(self, state_dict: dict[str, torch.Tensor], epoch: int, steps: int,
             metadata: dict[str, str] | None = None) -> Path:
        ...


class SafetensorsSavingCallback(ModelSavingCallback):
    """Write a safetensors file to disk."""

    def save(self, state_dict, epoch, steps, metadata=None) -> Path:
        from safetensors.torch import save_file

        path = self.get_save_path(epoch, steps)
        path.parent.mkdir(parents=True, exist_ok=True)
        save_file(
            {k: v.detach().cpu().contiguous() for k, v in state_dict.items()},
            str(path), metadata=metadata,
        )
        return path


def get_saving_callback(config: ModelSavingCallbackConfig) -> ModelSavingCallback:
    kwargs = config.model_dump()
    kind = kwargs.pop("type")
    if kind == "safetensors":
        return SafetensorsSavingCallback(**kwargs)
    if kind == "hf_hub":
        raise NotImplementedError(
            "the hf_hub saving callback needs the network and is out of the "
            "port's scope"
        )
    raise ValueError(f"Unknown saving callback type: {kind}")
