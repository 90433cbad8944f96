"""LoRA adapter layers (port of ``vision_pt_tpu/peft/lora.py``).

The factors are kept in the kohya/torch layout, ``lora_down.weight``
(rank, in) and ``lora_up.weight`` (out, rank), so the state dict is the
file layout with no transpose; ``alpha`` is a buffer, saved with the
factors so a checkpoint carries its scale.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.dtype import str_to_dtype
from .config import LoRAConfig
from .functional import PeftLayer, linear_features


def _tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))


class _Factor(nn.Module):
    """One LoRA factor: ``weight`` and an optional ``bias``; the JAX
    package holds the weight transposed, as a flax kernel."""

    flax_kernel = True

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias) if bias is not None else None


class LoRALinear(PeftLayer):
    """y = W x + (alpha / rank) * up(down(dropout(x))) over any linear of the
    port (``Linear``, ``torch.nn.Linear``, the quantized linears), whose own
    forward runs unchanged, quantized kernels included.

    ``lora_down`` is kaiming-uniform (bound sqrt(6 / in)) from ``generator``,
    ``lora_up`` zero, so a new adapter is the identity. The product runs in
    the adapters' dtype and is cast to the base output's.
    """

    adapter_weight_names = ["lora_up.weight", "lora_up.bias", "lora_down.weight",
                            "alpha"]

    def __init__(self, config: LoRAConfig, original_linear: nn.Module,
                 generator: torch.Generator | None = None):
        super().__init__()
        dtype = str_to_dtype(config.dtype)
        in_features, out_features, device = linear_features(original_linear)
        self.rank = config.rank
        self.enabled = True
        self.dropout_rate = config.dropout
        bound = math.sqrt(6.0 / in_features)
        down = torch.empty(config.rank, in_features, dtype=dtype, device=device)
        down.uniform_(-bound, bound, generator=generator)
        self.lora_down = _Factor(down)
        self.lora_up = _Factor(
            torch.zeros(out_features, config.rank, dtype=dtype, device=device),
            torch.zeros(out_features, dtype=dtype, device=device)
            if config.use_bias else None,
        )
        self.register_buffer("alpha", torch.tensor(config.alpha, dtype=dtype,
                                                   device=device))
        self.linear = original_linear

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        original = self.linear(x)
        if not self.enabled:
            return original
        h = x
        if self.dropout_rate > 0:
            h = F.dropout(h, self.dropout_rate, training=True)
        h = h.to(self.lora_down.weight.dtype)
        up = F.linear(F.linear(h, self.lora_down.weight), self.lora_up.weight,
                      self.lora_up.bias)
        scale = (self.alpha / self.rank).to(up.dtype)
        return original + (up * scale).to(original.dtype)

    # ------------------------------------------------------- weights IO

    def get_adapter_weights(self) -> dict[str, torch.Tensor]:
        """The adapter's tensors in the kohya layout, on the host."""
        out = {"lora_down.weight": self.lora_down.weight,
               "lora_up.weight": self.lora_up.weight, "alpha": self.alpha}
        if self.lora_up.bias is not None:
            out["lora_up.bias"] = self.lora_up.bias
        return {k: v.detach().cpu() for k, v in out.items()}

    def load_weights(self, adapter_weights: dict):
        """Take the given tensors (in their own dtype, as the JAX package
        does); a missing entry keeps its value."""
        device = self.alpha.device
        if (w := adapter_weights.get("lora_down.weight")) is not None:
            self.lora_down.weight = nn.Parameter(_tensor(w).to(device))
        if (w := adapter_weights.get("lora_up.weight")) is not None:
            self.lora_up.weight = nn.Parameter(_tensor(w).to(device))
        if (w := adapter_weights.get("lora_up.bias")) is not None:
            self.lora_up.bias = nn.Parameter(_tensor(w).to(device))
        if (w := adapter_weights.get("alpha")) is not None:
            self.alpha = _tensor(w).to(device)
            self.rank = int(self.lora_down.weight.shape[0])

    @classmethod
    def from_weights(cls, adapter_weights: dict,
                     original_layer: nn.Module) -> "LoRALinear":
        rank = int(_tensor(adapter_weights["lora_down.weight"]).shape[0])
        alpha = float(_tensor(adapter_weights["alpha"]))
        module = cls(LoRAConfig(rank=rank, alpha=alpha), original_layer)
        module.load_weights(adapter_weights)
        return module

    @torch.no_grad()
    def merged_weight(self) -> torch.Tensor:
        """W + (alpha / rank) up @ down, (out, in), for a dense base: the
        merged linear for export or inference."""
        delta = self.lora_up.weight.float() @ self.lora_down.weight.float()
        delta = delta * (self.alpha.float() / self.rank)
        weight = self.linear.weight
        return weight + delta.to(weight.dtype)
