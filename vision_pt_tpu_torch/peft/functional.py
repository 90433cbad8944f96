"""PEFT module-tree surgery (port of ``vision_pt_tpu/peft/functional.py``).

Matching linears are swapped for adapter layers that wrap them, in place,
by ``setattr`` on the parent. Paths are ``named_modules`` names, which are
the JAX package's paths for the port's modules (``nnx.List`` indices and
``nnx.Dict`` keys become ``ModuleList`` / ``ModuleDict`` names). The JAX
package trains adapters by differentiating with respect to
``AdapterParam``; here :func:`freeze_all_but_adapters` clears
``requires_grad`` on everything else and the optimizer takes
:func:`adapter_parameters`: those of the adapter layers and every
:class:`AdapterParam` (the image adapters' and projectors').
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from typing import Callable, Iterator, NamedTuple

import torch
from torch import nn

from ..ops.linear import Linear
from ..ops.quant.layers import QuantLinear4bit, QuantLinearFP8, QuantLinearInt8
from .config import PEFT_TYPE, PeftConfigMixin, get_target_keys

_LINEARS = (Linear, nn.Linear, QuantLinear4bit, QuantLinearInt8, QuantLinearFP8)


class PeftLayer(nn.Module):
    """Base of the adapter layers."""

    adapter_weight_names: list[str]
    enabled: bool

    def set_enabled(self, enabled: bool):
        self.enabled = enabled

    def adapter_parameters(self) -> Iterator[nn.Parameter]:
        """Every parameter of the adapter, not of the wrapped linear."""
        for name, p in self.named_parameters():
            if not name.startswith("linear."):
                yield p


def linear_features(linear: nn.Module) -> tuple[int, int, torch.device]:
    """(in_features, out_features, device) of any linear of the port."""
    if isinstance(linear, (Linear, nn.Linear)):
        out_features, in_features = linear.weight.shape
        return in_features, out_features, linear.weight.device
    buffer = next(linear.buffers())
    return linear.in_features, linear.out_features, buffer.device


def _make_peft_layer(module: nn.Module, config: PeftConfigMixin,
                     generator: torch.Generator | None) -> PeftLayer:
    from .config import LoHaConfig, LoRAConfig
    from .loha import LoHaLinear
    from .lora import LoRALinear

    if config.type == "lora":
        return LoRALinear(LoRAConfig.model_validate(config.model_dump()), module,
                          generator=generator)
    if config.type == "loha":
        return LoHaLinear(LoHaConfig.model_validate(config.model_dump()), module,
                          generator=generator)
    raise ValueError(f"Unknown peft type: {config.type}")


def replace_to_peft_layer(model: nn.Module, include_keys, exclude_keys,
                          config: PeftConfigMixin, seed: int = 0) -> list[str]:
    """Swap the matching linears for adapter layers in place; returns the
    replaced paths. The factors are drawn in module order from one
    generator seeded with ``seed`` on each linear's device."""
    all_paths = [path for path, _ in model.named_modules()]
    target_keys = set(get_target_keys(include_keys, exclude_keys, all_paths))
    generators: dict[torch.device, torch.Generator] = {}
    replaced: list[str] = []

    def generator_for(linear):
        device = linear_features(linear)[2]
        if device not in generators:
            generators[device] = torch.Generator(device=device).manual_seed(seed)
        return generators[device]

    def visit(module: nn.Module, prefix: str):
        for name, child in list(module.named_children()):
            full = f"{prefix}{name}"
            if isinstance(child, PeftLayer):
                continue
            if isinstance(child, _LINEARS):
                if full in target_keys:
                    setattr(module, name, _make_peft_layer(child, config,
                                                           generator_for(child)))
                    replaced.append(full)
                continue
            visit(child, f"{full}.")

    visit(model, "")
    return replaced


def peft_layers(model: nn.Module) -> Iterator[tuple[str, PeftLayer]]:
    for path, module in model.named_modules():
        if isinstance(module, PeftLayer):
            yield path, module


class AdapterParam(nn.Parameter):
    """A parameter that trains under PEFT besides the adapter layers' own
    (the JAX package's ``AdapterParam``): an image adapter's projections and
    gates, an image projector."""


def retype_to_adapter_params(module: nn.Module) -> None:
    """Retype every parameter of ``module`` to :class:`AdapterParam`."""
    for mod in module.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            if not isinstance(p, AdapterParam):
                setattr(mod, name, AdapterParam(p.data, p.requires_grad))


def adapter_parameters(model: nn.Module) -> list[nn.Parameter]:
    """The adapter layers' parameters, in module order, then every
    :class:`AdapterParam` (what the optimizer takes under PEFT)."""
    out = [p for _, layer in peft_layers(model) for p in layer.adapter_parameters()]
    seen = {id(p) for p in out}
    return out + [p for p in model.parameters()
                  if isinstance(p, AdapterParam) and id(p) not in seen]


def freeze_all_but_adapters(model: nn.Module) -> None:
    """Only the adapters take gradients."""
    adapters = {id(p) for p in adapter_parameters(model)}
    for p in model.parameters():
        p.requires_grad_(id(p) in adapters)


# ----------------------------------------------------------- state dict


def get_adapter_parameters(model: nn.Module) -> dict[str, torch.Tensor]:
    """The adapters' state dict in the kohya layout, keyed by module path."""
    out: dict[str, torch.Tensor] = {}
    for path, layer in peft_layers(model):
        for key, value in layer.get_adapter_weights().items():
            out[f"{path}.{key}" if path else key] = value
    return out


def detect_peft_method(state_dict: dict) -> PEFT_TYPE:
    """The adapter type from a checkpoint's keys."""
    if any(k.endswith(".lora_up.weight") for k in state_dict):
        return "lora"
    if any(k.endswith(".hada_w1_a") for k in state_dict):
        return "loha"
    return "none"


def load_peft_weight(model: nn.Module, state_dict: dict) -> list[str]:
    """Load adapters from a state dict keyed by module path: an adapter
    layer takes its weights, a linear with weights in the file is wrapped
    in a new adapter of the file's type. Returns the affected paths."""
    from .loha import LoHaLinear
    from .lora import LoRALinear

    peft_type = detect_peft_method(state_dict)
    if peft_type == "none":
        raise ValueError("Failed to detect peft method from state_dict")
    peft_class = LoRALinear if peft_type == "lora" else LoHaLinear
    affected: list[str] = []

    def visit(module: nn.Module, prefix: str):
        for name, child in list(module.named_children()):
            full = f"{prefix}{name}"
            adapter_sd = {wn: state_dict.get(f"{full}.{wn}")
                          for wn in peft_class.adapter_weight_names}
            complete = all(v is not None for k, v in adapter_sd.items()
                           if "bias" not in k)
            if isinstance(child, PeftLayer):
                if complete:
                    child.load_weights(adapter_sd)
                    affected.append(full)
                continue
            if isinstance(child, _LINEARS):
                if complete:
                    setattr(module, name, peft_class.from_weights(adapter_sd, child))
                    affected.append(full)
                continue
            visit(child, f"{full}.")

    visit(model, "")
    return affected


# ----------------------------------------------------------- enable/disable


def set_peft_layer_enabled(model: nn.Module, enabled: bool) -> None:
    for _, layer in peft_layers(model):
        layer.set_enabled(enabled)


@contextmanager
def while_peft_disabled(model: nn.Module):
    """The base model alone for the duration."""
    try:
        set_peft_layer_enabled(model, False)
        yield
    finally:
        set_peft_layer_enabled(model, True)


@contextmanager
def while_peft_enabled(model: nn.Module):
    try:
        set_peft_layer_enabled(model, True)
        yield
    finally:
        set_peft_layer_enabled(model, False)


# ----------------------------------------------------------- reporting


class TrainableParameters(NamedTuple):
    trainable_params: int
    all_param: int
    trainable_percent: float


def calculate_trainable_parameters(model: nn.Module,
                                   is_peft: bool | None = None) -> TrainableParameters:
    """With adapters, the adapters' parameters are the trainable ones;
    without, every parameter. Quantized weights are buffers and not
    counted, as in the JAX package."""
    all_param = sum(p.numel() for p in model.parameters())
    adapter_param = sum(p.numel() for p in adapter_parameters(model))
    has_adapters = adapter_param > 0 if is_peft is None else is_peft
    trainable = adapter_param if has_adapters else all_param
    return TrainableParameters(trainable, all_param,
                               100.0 * trainable / max(all_param, 1))


def human_readable_param(n: int) -> str:
    for unit, value in [("T", 10**12), ("B", 10**9), ("M", 10**6), ("K", 10**3)]:
        if n >= value:
            return f"{n / value:.2f}{unit}"
    return str(n)


def print_trainable_parameters(model: nn.Module, print_fn: Callable = print):
    tp = calculate_trainable_parameters(model)
    print_fn(f"Trainable params: {human_readable_param(tp.trainable_params)}, "
             f"All params: {human_readable_param(tp.all_param)}, "
             f"Trainable%: {tp.trainable_percent:.4f}%")
    if tp.trainable_params == 0:
        warnings.warn("No trainable parameters found — check your peft config")
