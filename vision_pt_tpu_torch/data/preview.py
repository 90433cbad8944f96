"""Preview-generation job list (the port's own copy of
``vision_pt_tpu/data/preview.py``)."""

from __future__ import annotations

import json
from pathlib import Path

import yaml
from pydantic import BaseModel


class T2IPreviewArgs(BaseModel):
    """One preview generation job."""

    prompt: str
    negative_prompt: str | None = None
    width: int = 256
    height: int = 256
    cfg_scale: float = 2.0
    num_steps: int = 20
    seed: int = 42
    extra: dict = {}


class TextToImagePreviewConfig(BaseModel):
    """Preview jobs given inline (``data``) or in a YAML/JSON file (``path``)."""

    path: str | None = None
    data: list[T2IPreviewArgs] = []

    def get_preview_args(self) -> list[T2IPreviewArgs]:
        if self.path is None:
            return self.data
        p = Path(self.path)
        raw = p.read_text()
        items = yaml.safe_load(raw) if p.suffix in (".yml", ".yaml") else json.loads(raw)
        return [T2IPreviewArgs.model_validate(item) for item in items]
