"""LoHa adapter layers (port of ``vision_pt_tpu/peft/loha.py``; LyCORIS
Hadamard-product low-rank adaptation).

delta_W = (w1_a @ w1_b) * (w2_a @ w2_b), (in, out), applied as
``x @ delta_W * alpha / rank``. The factors keep the JAX package's file
layout, ``hada_w1_a`` / ``hada_w2_a`` (in, rank) and ``hada_w1_b`` /
``hada_w2_b`` (rank, out), so a state dict is the file with no transpose;
``alpha`` is a buffer, saved with the factors.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.dtype import str_to_dtype
from .config import LoHaConfig
from .functional import PeftLayer, linear_features

_FACTORS = ("hada_w1_a", "hada_w1_b", "hada_w2_a", "hada_w2_b")


def _tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))


class LoHaLinear(PeftLayer):
    """y = W x + (alpha / rank) x @ ((w1_a @ w1_b) * (w2_a @ w2_b)) over any
    linear of the port (``Linear``, ``torch.nn.Linear``, the quantized
    linears), whose own forward runs unchanged, quantized kernels included.

    From ``generator``: w1_a ~ N(0, 0.1^2), w1_b ~ N(0, 1), w2_b ~ N(0, 1);
    w2_a is zero, so a new adapter is the identity. The product runs in the
    adapters' dtype and is cast to the base output's. ``dropout`` is taken
    and, as in the JAX package, not applied.
    """

    adapter_weight_names = [*_FACTORS, "alpha"]

    def __init__(self, config: LoHaConfig, original_linear: nn.Module,
                 generator: torch.Generator | None = None):
        super().__init__()
        dtype = str_to_dtype(config.dtype)
        in_features, out_features, device = linear_features(original_linear)
        self.rank = config.rank
        self.enabled = True
        self.dropout_rate = config.dropout
        kw = dict(dtype=dtype, device=device)

        def normal(*shape):
            return torch.randn(shape, generator=generator, **kw)

        self.hada_w1_a = nn.Parameter(normal(in_features, config.rank) * 0.1)
        self.hada_w1_b = nn.Parameter(normal(config.rank, out_features))
        self.hada_w2_a = nn.Parameter(torch.zeros(in_features, config.rank, **kw))
        self.hada_w2_b = nn.Parameter(normal(config.rank, out_features))
        self.register_buffer("alpha", torch.tensor(config.alpha, **kw))
        self.linear = original_linear

    def delta_weight(self) -> torch.Tensor:
        """(w1_a @ w1_b) * (w2_a @ w2_b), (in, out), before the scale."""
        return (self.hada_w1_a @ self.hada_w1_b) * (self.hada_w2_a @ self.hada_w2_b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        original = self.linear(x)
        if not self.enabled:
            return original
        delta = self.delta_weight()
        scale = (self.alpha / self.rank).to(delta.dtype)
        out = (x.to(delta.dtype) @ delta) * scale
        return original + out.to(original.dtype)

    # ------------------------------------------------------- weights IO

    def get_adapter_weights(self) -> dict[str, torch.Tensor]:
        """The factors and alpha in the file layout, on the host."""
        out = {name: getattr(self, name) for name in self.adapter_weight_names}
        return {k: v.detach().cpu() for k, v in out.items()}

    def load_weights(self, adapter_weights: dict):
        """Take the given tensors (in their own dtype, as the JAX package
        does); a missing entry keeps its value."""
        device = self.alpha.device
        for name in _FACTORS:
            if (w := adapter_weights.get(name)) is not None:
                setattr(self, name, nn.Parameter(_tensor(w).to(device)))
        if (w := adapter_weights.get("alpha")) is not None:
            self.alpha = _tensor(w).to(device)
        self.rank = int(self.hada_w1_a.shape[1])

    @classmethod
    def from_weights(cls, adapter_weights: dict,
                     original_layer: nn.Module) -> "LoHaLinear":
        rank = int(_tensor(adapter_weights["hada_w1_a"]).shape[1])
        alpha = float(_tensor(adapter_weights["alpha"]))
        module = cls(LoHaConfig(rank=rank, alpha=alpha), original_layer)
        module.load_weights(adapter_weights)
        return module
