"""Quantization flows (port of ``vision_pt_tpu/ops/quant/functional.py``):

(a) ``replace_to_quant_linear``: swap linears before loading
(b) ``quantize_inplace``: quantize already-loaded weights
(c) ``replace_by_prequantized_weights``: sniff quant-state keys in a
    checkpoint and swap the matching layers (``load_state_with_prequantized``
    then loads the whole state)
(d) ``quantize_state_dict``: offline checkpoint quantization

The JAX package's NNX surgery becomes ``named_modules`` and ``setattr`` on
the parent. A linear is the port's ``ops.linear.Linear`` or a
``torch.nn.Linear``.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch
from torch import nn

from ...utils.state_dict import get_target_keys
from ..linear import Linear
from .layers import QuantLinear4bit, QuantLinearFP8, QuantLinearInt8
from .nf4 import quantize_4bit, quantize_4bit_device, state_to_bnb_dict

QUANT_TYPE = Literal[
    "fp8_e4m3fn",
    "bnb_int8",
    "bnb_fp4",
    "bnb_nf4",
    "quanto_int4",
    "quanto_int8",
    "ao_nf4",
    "ao_fp8",
]

_FOUR_BIT = {"bnb_fp4": "fp4", "bnb_nf4": "nf4", "ao_nf4": "nf4",
             "quanto_int4": "nf4"}
_INT8 = {"bnb_int8", "quanto_int8"}
_FP8 = {"fp8_e4m3fn", "ao_fp8"}
_LINEARS = (Linear, nn.Linear)


def _quantize_linear(linear: nn.Module, quant_type: QUANT_TYPE) -> nn.Module:
    if quant_type in _FOUR_BIT:
        return QuantLinear4bit.from_linear(linear, quant_type=_FOUR_BIT[quant_type])
    if quant_type in _INT8:
        return QuantLinearInt8.from_linear(linear)
    if quant_type in _FP8:
        return QuantLinearFP8.from_linear(linear)
    raise ValueError(f"Unknown quant type: {quant_type}")


def _linears(model: nn.Module):
    """(path, parent, attribute, linear) of every linear, depth first."""
    parents = dict(model.named_modules())
    for path, module in list(model.named_modules()):
        if isinstance(module, _LINEARS):
            parent, _, name = path.rpartition(".")
            yield path, parents[parent], name, module


@torch.no_grad()
def quantize_inplace(
    model: nn.Module,
    quant_type: QUANT_TYPE,
    include_keys: list[str],
    exclude_keys: list[str] = (),
) -> list[str]:
    """Quantize the loaded linears whose module paths match the key
    patterns, each on its own device. Returns the replaced paths."""
    paths = [p for p, _ in model.named_modules()]
    targets = set(get_target_keys(paths, list(include_keys), list(exclude_keys)))
    replaced = []
    for path, parent, name, linear in _linears(model):
        if path in targets:
            setattr(parent, name, _quantize_linear(linear, quant_type))
            replaced.append(path)
    return replaced


# the pre-load flow of the reference: without an empty-weights phase both
# flows are the same surgery
replace_to_quant_linear = quantize_inplace


def detect_quant_type(children: dict) -> QUANT_TYPE | None:
    """Sniff the quant type from a layer's ``weight.*`` child keys."""
    for key, tensor in children.items():
        if "quant_state" in key:
            qt = key.split("bitsandbytes__")[-1]
            if qt == "nf4":
                return "bnb_nf4"
            if qt == "fp4":
                return "bnb_fp4"
        elif "weight_format" in key:
            return "bnb_int8"
        elif "_data" in key:
            return "quanto_int8" if np.asarray(tensor).dtype == np.int8 else "quanto_int4"
    return None


@torch.no_grad()
def replace_by_prequantized_weights(model: nn.Module, state_dict: dict) -> list[str]:
    """Swap the linears whose checkpoint entries carry quant-state keys,
    loading their packed weights."""
    replaced = []
    for path, parent, name, linear in _linears(model):
        children = {k[len(path) + len(".weight."):]: v for k, v in state_dict.items()
                    if k.startswith(f"{path}.weight.")}
        quant_type = detect_quant_type(children) if children else None
        if quant_type is None:
            continue
        out_features, in_features = linear.weight.shape
        use_bias = linear.bias is not None
        with torch.device(linear.weight.device):
            if quant_type in _FOUR_BIT:
                q = QuantLinear4bit(in_features, out_features, use_bias=use_bias)
                q.load_prequantized(state_dict[f"{path}.weight"], children,
                                    bias=state_dict.get(f"{path}.bias"))
            elif quant_type in _INT8:
                q = QuantLinearInt8(in_features, out_features, use_bias=use_bias)
                q.qweight = torch.as_tensor(
                    np.asarray(state_dict[f"{path}.weight"], dtype=np.int8)).to(
                        q.qweight.device)
                scale = children.get("SCB", children.get("_scale"))
                if scale is not None:
                    q.scale = torch.as_tensor(
                        np.asarray(scale, dtype=np.float32).reshape(-1)).to(
                            q.scale.device)
            else:
                continue
        setattr(parent, name, q)
        replaced.append(path)
    return replaced


def load_state_with_prequantized(module: nn.Module, state: dict,
                                 strict: bool = True) -> list[str]:
    """Load a state in the port's key layout into ``module``, plain or with
    linears prequantized in the bnb layout: the linears whose entries carry
    quant-state keys are swapped for quantized layers holding those weights
    first. Returns the swapped paths."""
    replaced = replace_by_prequantized_weights(module, state)
    for path in replaced:
        weight = f"{path}.weight"
        state = {k: v for k, v in state.items()
                 if k != weight and not k.startswith(weight + ".")}
        state.update({f"{path}.{name}": buf for name, buf in
                      module.get_submodule(path).named_buffers()})
    module.load_state_dict(
        {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
         for k, v in state.items()}, strict=strict)
    return replaced


def quantize_state_dict(
    state_dict: dict[str, np.ndarray],
    quant_type: QUANT_TYPE,
    include_keys: list[str],
    exclude_keys: list[str] = (),
    device: str | torch.device | None = None,
) -> dict:
    """Offline checkpoint quantization: torch-layout (out, in) weights in,
    bnb-format packed tensors out (fp8 as a torch float8_e4m3fn tensor).
    With ``device``, each 4-bit weight is quantized there
    (:func:`quantize_4bit_device`, the same codes) and fetched once."""
    if quant_type not in ("bnb_nf4", "bnb_fp4", "fp8_e4m3fn"):
        raise NotImplementedError(
            "Only bnb 4-bit and fp8_e4m3fn offline quantization is supported"
        )
    targets = set(get_target_keys(list(state_dict), list(include_keys),
                                  list(exclude_keys)))
    out = dict(state_dict)
    for key in list(out):
        if key not in targets or not key.endswith(".weight"):
            continue
        if quant_type in ("bnb_nf4", "bnb_fp4"):
            four_bit = quant_type[len("bnb_"):]
            if device is not None:
                weight = out[key]
                if not isinstance(weight, torch.Tensor):
                    weight = torch.as_tensor(np.asarray(weight, dtype=np.float32))
                packed, state = quantize_4bit_device(
                    weight.to(device, torch.float32), quant_type=four_bit)
            else:
                packed, state = quantize_4bit(np.asarray(out[key], dtype=np.float32),
                                              quant_type=four_bit)
            out[key] = packed
            for sk, sv in state_to_bnb_dict(state).items():
                out[f"{key}.{sk}"] = sv
        else:
            out[key] = torch.as_tensor(np.asarray(out[key], dtype=np.float32)).to(
                torch.float8_e4m3fn)
    return out
