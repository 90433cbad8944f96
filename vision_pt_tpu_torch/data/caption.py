"""Composable caption processors (the port's own copy of
``vision_pt_tpu/data/caption.py``).

Pydantic string transforms, told apart by ``type``, applied per sample.
Randomised processors take an optional ``rng`` (a numpy Generator) so the
data pipeline stays reproducible; without one they draw from a fresh
generator.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Literal, Union

import numpy as np
from pydantic import BaseModel

class CaptionProcessorMixin(ABC, BaseModel):
    type: str

    @abstractmethod
    def process(self, caption: str, rng: np.random.Generator | None = None) -> str:
        ...

    def __call__(self, caption: str, rng: np.random.Generator | None = None) -> str:
        return self.process(caption, rng)


def _rng(rng: np.random.Generator | None) -> np.random.Generator:
    return rng if rng is not None else np.random.default_rng()


class CaptionPassthrough(CaptionProcessorMixin):
    type: Literal["passthrough"] = "passthrough"

    def process(self, caption, rng=None):
        return caption


class CaptionPrefix(CaptionProcessorMixin):
    type: Literal["prefix"] = "prefix"
    prefix: str

    def process(self, caption, rng=None):
        return self.prefix + caption


class CaptionSuffix(CaptionProcessorMixin):
    type: Literal["suffix"] = "suffix"
    suffix: str

    def process(self, caption, rng=None):
        return caption + self.suffix


class CaptionRandomPrefix(CaptionProcessorMixin):
    type: Literal["prefix_random"] = "prefix_random"
    prefix: list[str]

    def process(self, caption, rng=None):
        return self.prefix[int(_rng(rng).integers(len(self.prefix)))] + caption


class CaptionRandomSuffix(CaptionProcessorMixin):
    type: Literal["suffix_random"] = "suffix_random"
    suffix: list[str]

    def process(self, caption, rng=None):
        return caption + self.suffix[int(_rng(rng).integers(len(self.suffix)))]


class CaptionDrop(CaptionProcessorMixin):
    type: Literal["drop"] = "drop"
    drop_rate: float

    def process(self, caption, rng=None):
        return "" if _rng(rng).random() < self.drop_rate else caption


class CaptionTagDrop(CaptionProcessorMixin):
    type: Literal["tag_drop"] = "tag_drop"
    drop_rate: float
    separator: str = ","

    def process(self, caption, rng=None):
        r = _rng(rng)
        tags = [t for t in caption.split(self.separator) if r.random() >= self.drop_rate]
        return self.separator.join(tags)


class CaptionShuffle(CaptionProcessorMixin):
    type: Literal["shuffle"] = "shuffle"
    split_separator: str = ","
    trim: bool = True
    concat_separator: str = ", "

    def process(self, caption, rng=None):
        items = [
            item.strip() if self.trim else item
            for item in caption.split(self.split_separator)
        ]
        _rng(rng).shuffle(items)
        return self.concat_separator.join(items)


class CaptionShuffleInGroup(CaptionProcessorMixin):
    """Shuffle within ``|||``-separated groups, preserving group order."""

    type: Literal["shuffle_in_group"] = "shuffle_in_group"
    group_separator: str = "|||"
    split_separator: str = ","
    trim: bool = True
    concat_separator: str = ", "

    def _shuffle(self, group: str, rng) -> str:
        items = [
            item.strip() if self.trim else item
            for item in group.split(self.split_separator)
        ]
        rng.shuffle(items)
        return self.concat_separator.join(items)

    def process(self, caption, rng=None):
        r = _rng(rng)
        groups = caption.split(self.group_separator)
        return self.concat_separator.join(self._shuffle(g, r) for g in groups)


class CaptionReplace(CaptionProcessorMixin):
    type: Literal["replace"] = "replace"
    source: str
    target: str

    def process(self, caption, rng=None):
        return caption.replace(self.source, self.target)


CaptionProcessorAlias = Union[
    CaptionPassthrough,
    CaptionPrefix,
    CaptionSuffix,
    CaptionRandomPrefix,
    CaptionRandomSuffix,
    CaptionDrop,
    CaptionTagDrop,
    CaptionShuffle,
    CaptionShuffleInGroup,
    CaptionReplace,
]

CaptionProcessorList = list[CaptionProcessorAlias]


def apply_caption_processors(
    caption: str,
    processors: list[CaptionProcessorMixin],
    rng: np.random.Generator | None = None,
) -> str:
    for proc in processors:
        caption = proc(caption, rng)
    return caption
