"""Layer-group offloading: device <-> pinned host memory swapping during a
forward (port of ``vision_pt_tpu/ops/offload.py``).

At each group's first layer the previous group's parameters and buffers move
to pinned host memory and the group's own to the device. Each tensor keeps
one pinned host buffer, made at its first move and reused after. The copies
are asynchronous on the current stream, so they are ordered with the kernels
that read the layers and the results are those of the same run without
offload. ``enabled=None`` means on when the layers' parameters are on a CUDA
device (the JAX package's ``_supports_pinned_host``, true only on a TPU):
on the CPU every call is a no-op.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple, Sequence

import torch
from torch import nn


class GroupOffloadArgs(NamedTuple):
    layer_indices: list[int]
    to_host: bool


def _tensors(module: nn.Module):
    """(owner, name, tensor, is_parameter) of every parameter and buffer."""
    for owner in module.modules():
        for name, p in owner._parameters.items():
            if p is not None:
                yield owner, name, p, True
        for name, b in owner._buffers.items():
            if b is not None:
                yield owner, name, b, False


@torch.inference_mode(False)
@torch.no_grad()
def _move_module(module: nn.Module, device: torch.device | None,
                 pinned: dict) -> None:
    """To ``device``, or to pinned host memory for ``None``. The new tensors
    are ordinary ones even when a forward under inference mode moves them."""
    for owner, name, tensor, is_parameter in _tensors(module):
        if device is None:
            if tensor.device.type == "cpu":
                continue
            key = (id(owner), name)
            host = pinned.get(key)
            if host is None or host.shape != tensor.shape or host.dtype != tensor.dtype:
                host = pinned[key] = torch.empty(tensor.shape, dtype=tensor.dtype,
                                                 pin_memory=True)
            moved = host.copy_(tensor, non_blocking=True)
        elif tensor.device != device:
            moved = tensor.to(device, non_blocking=True)
        else:
            continue
        if is_parameter:
            tensor.data = moved
        else:
            owner._buffers[name] = moved


class LayerwiseOffloadStrategy:
    """Group-of-layers schedule: at each group's first layer, the previous
    group moves to the host and the new group to the device."""

    def __init__(self, layer_groups: Sequence[Sequence[int]],
                 enabled: bool | None = None):
        group_starts = [group[0] for group in layer_groups]
        total = sum(len(g) for g in layer_groups)
        self.offload_args: list[tuple[GroupOffloadArgs, GroupOffloadArgs] | None]
        self.offload_args = [None] * total
        for i, (start, group) in enumerate(zip(group_starts, layer_groups)):
            previous = list(layer_groups[i - 1]) if i > 0 else []
            self.offload_args[start] = (
                GroupOffloadArgs(previous, to_host=True),
                GroupOffloadArgs(list(group), to_host=False),
            )
        self.layer_groups = layer_groups
        self.enabled = enabled
        self.device: torch.device | None = None
        self._pinned: dict = {}

    @classmethod
    def from_num_groups(cls, num_layers: int, num_groups: int,
                        **kw) -> "LayerwiseOffloadStrategy":
        per = -(-num_layers // num_groups)
        groups = [list(range(i, min(i + per, num_layers)))
                  for i in range(0, num_layers, per)]
        return cls(groups, **kw)

    def _active(self, layers: Sequence[nn.Module]) -> bool:
        """Resolve the device (and ``enabled=None``) from the layers at the
        first call, before anything has moved."""
        if self.device is None:
            self.device = next(p.device for layer in layers for p in layer.parameters())
            if self.enabled is None:
                self.enabled = self.device.type == "cuda"
        return bool(self.enabled)

    def should_offload(self, layer_idx: int) -> bool:
        return self.offload_args[layer_idx] is not None

    def maybe_offload_layers(self, layers: Sequence[nn.Module],
                             current_index: int) -> None:
        if not self._active(layers) or not self.should_offload(current_index):
            return
        prev_group, next_group = self.offload_args[current_index]
        for idx in prev_group.layer_indices:
            _move_module(layers[idx], None, self._pinned)
        for idx in next_group.layer_indices:
            _move_module(layers[idx], self.device, self._pinned)

    def offload_all(self, layers: Sequence[nn.Module]) -> None:
        if not self._active(layers):
            return
        for layer in layers:
            _move_module(layer, None, self._pinned)

    def load_all(self, layers: Sequence[nn.Module]) -> None:
        if not self._active(layers):
            return
        for layer in layers:
            _move_module(layer, self.device, self._pinned)


class OffloadableModuleMixin:
    offload_strategy: LayerwiseOffloadStrategy | None = None

    def set_offload_strategy(self, strategy: LayerwiseOffloadStrategy | None):
        self.offload_strategy = strategy

    def maybe_offload_by_group(self, layers: Sequence[nn.Module],
                               current_index: int) -> None:
        if self.offload_strategy is not None:
            self.offload_strategy.maybe_offload_layers(layers, current_index)

    @contextmanager
    def while_offloaded(self, layers: Sequence[nn.Module]):
        """Park all groups on the host for the scope, restoring on exit."""
        if self.offload_strategy is None:
            yield
            return
        try:
            self.offload_strategy.offload_all(layers)
            yield
        finally:
            self.offload_strategy.load_all(layers)
