"""Adapter framework (port of ``vision_pt_tpu/adapters/util.py``).

An ``Adapter`` replaces a module whose path matches its ``target_key``
regex. ``AdapterManager`` does the surgery, keeps the adapters by escaped
path ('.' -> '!', the checkpoint convention of the adapter files) and
(de)serializes the adapters' own weights. Paths are ``named_children`` names
from the root, which are the JAX package's paths for the port's modules; the
root may be a pipeline object that is not itself a module (``SDXLModel``),
whose public module attributes are its children.
"""

from __future__ import annotations

import re
from abc import abstractmethod
from typing import Iterator

import torch
from torch import nn

from ..peft.config import RegexMatch


class Adapter(nn.Module):
    """Base of the adapters: built from the module it replaces."""

    target_key: RegexMatch

    @classmethod
    def from_module(cls, module: nn.Module, config, **kwargs) -> "Adapter":
        raise NotImplementedError

    @abstractmethod
    def get_adapter_state(self) -> dict[str, torch.Tensor]:
        """The adapter's own weights (not those of the module it wraps), on
        the host, in the adapter file's layout."""

    @abstractmethod
    def load_adapter_state(self, sd: dict) -> None:
        ...


def _children(obj) -> Iterator[tuple[str, nn.Module]]:
    if isinstance(obj, nn.Module):
        yield from obj.named_children()
        return
    for name, value in vars(obj).items():
        if not name.startswith("_") and isinstance(value, nn.Module):
            yield name, value


class AdapterManager:
    """Applies one adapter class over a model and holds its adapters."""

    def __init__(self, adapter_class: type[Adapter], adapter_config):
        self.module_dict: dict[str, Adapter] = {}
        self.adapter_class = adapter_class
        self.adapter_config = adapter_config

    def apply_adapter(self, model, **from_module_kwargs) -> list[str]:
        """Replace every module whose path matches the adapter's target_key;
        returns the replaced paths."""
        pattern = re.compile(self.adapter_class.target_key.regex)
        replaced: list[str] = []

        def visit(module, prefix: str):
            for name, child in list(_children(module)):
                full = f"{prefix}{name}"
                if isinstance(child, Adapter):
                    continue
                if pattern.match(full):
                    adapter = self.adapter_class.from_module(
                        child, self.adapter_config, **from_module_kwargs)
                    setattr(module, name, adapter)
                    self.module_dict[full.replace(".", "!")] = adapter
                    replaced.append(full)
                    continue
                visit(child, f"{full}.")

        visit(model, "")
        return replaced

    def get_state_dict(self) -> dict[str, torch.Tensor]:
        """The adapters' weights under escaped-path keys ('.' -> '!' in the
        module path, not in the parameter suffix)."""
        return {f"{key}.{pkey}": value
                for key, adapter in self.module_dict.items()
                for pkey, value in adapter.get_adapter_state().items()}

    def load_adapter_state(self, state_dict: dict) -> None:
        for key, adapter in self.module_dict.items():
            prefix = f"{key}."
            sub = {k[len(prefix):]: v for k, v in state_dict.items()
                   if k.startswith(prefix)}
            if sub:
                adapter.load_adapter_state(sub)
