"""PEFT configuration (the port's own copy of ``vision_pt_tpu/peft/config.py``)."""

from __future__ import annotations

import re
from typing import Literal, Union

from pydantic import BaseModel, field_validator

PEFT_TYPE = Literal["lora", "loha", "none"]


class RegexMatch(BaseModel):
    """A key matcher by ``re.match``."""

    regex: str

    def __call__(self, value: str) -> bool:
        return bool(re.match(self.regex, value))


class PeftConfigMixin(BaseModel):
    type: PEFT_TYPE
    dtype: str = "bfloat16"


class LoRAConfig(PeftConfigMixin):
    type: Literal["lora"] = "lora"
    rank: int
    alpha: float = 1.0
    dropout: float = 0.0
    use_bias: bool = False


class LoHaConfig(PeftConfigMixin):
    type: Literal["loha"] = "loha"
    rank: int
    alpha: float = 1.0
    dropout: float = 0.0


PeftConfigUnion = Union[LoRAConfig, LoHaConfig]


class PeftTargetConfig(BaseModel):
    """Which layers take adapters, and the adapters' config."""

    include_keys: list[str | RegexMatch] = []
    exclude_keys: list[str | RegexMatch] = []
    config: PeftConfigUnion
    resume_weight_path: str | None = None
    resume_rename_key_map: dict[str, str] = {}

    @field_validator("include_keys")
    @classmethod
    def check_include_keys(cls, v):
        if len(v) == 0:
            raise ValueError("include_keys must not be empty")
        return v


def get_target_keys(include, exclude, keys: list[str]) -> list[str]:
    """The keys that an include pattern matches and no exclude pattern does:
    a string matches a key it is a substring of, a ``RegexMatch`` by
    ``re.match``."""

    def matching(pattern) -> set[str]:
        if isinstance(pattern, RegexMatch):
            rx = re.compile(pattern.regex)
            return {k for k in keys if rx.match(k)}
        return {k for k in keys if pattern in k}

    matched: set[str] = set()
    for pattern in include:
        matched |= matching(pattern)
    for pattern in exclude:
        matched -= matching(pattern)
    return sorted(matched)
