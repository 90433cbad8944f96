"""Dynamic int8 quantized-training matmul (port of
``vision_pt_tpu/ops/quant/int8_training.py``).

Both operands are quantized on the fly, symmetric to int8 (the activations
per row, the weight per output column), contracted with int32 accumulation
and rescaled in fp32; the backward is straight-through, the gradients of
the unquantized product. Master weights and optimizer state keep their
dtype. The JAX package computes the product with ``lax.dot_general``
outside any Pallas kernel; here ``torch._int_mm`` (the library's int8
product) carries it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..linear import Linear


def _rowwise_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: (q, scale (..., 1)), the scale in x's dtype."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq (M, K) @ wq (N, K)^T in int32, exactly. On CUDA ``torch._int_mm``
    wants M > 16 and K, N multiples of 8: the operands are padded with zero
    rows and columns, which add nothing, and the product is cut back."""
    m, k = xq.shape
    n = wq.shape[0]
    if not xq.is_cuda:
        return torch._int_mm(xq, wq.t())
    pad_m, pad_k, pad_n = max(17 - m, 0), -k % 8, -n % 8
    if pad_m or pad_k:
        xq = F.pad(xq, (0, pad_k, 0, pad_m))
    if pad_n or pad_k:
        wq = F.pad(wq, (0, pad_k, 0, pad_n))
    return torch._int_mm(xq.contiguous(), wq.contiguous().t())[:m, :n]


class _Int8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        xq, sx = _rowwise_quant(x)
        wq, sw = _rowwise_quant(weight)  # per output column of x @ weight^T
        y = int8_product(xq, wq).float() * sx.float() * sw[:, 0].float()[None, :]
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        gx = (g @ weight.to(g.dtype)).to(x.dtype)
        gw = (g.t() @ x.to(g.dtype)).to(weight.dtype)
        return gx, gw


def int8_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """y = x @ weight^T for x (M, K) and a weight (N, K), the port's linear
    layout, with the forward contraction in int8 -> int32 and a
    straight-through backward."""
    return _Int8MatMul.apply(x, weight)


class Int8TrainLinear(Linear):
    """``Linear`` whose forward contraction runs in int8: the same
    parameters and checkpoint layout, only the compute path changes. With
    ``dtype`` set, input and weight are cast to it first, as ``nnx.Linear``
    does; the output takes the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight
        if self.dtype is not None:
            x, weight = x.to(self.dtype), weight.to(self.dtype)
        lead = x.shape[:-1]
        y = int8_matmul(x.reshape(-1, x.shape[-1]), weight)
        y = y.reshape(*lead, weight.shape[0])
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def quantize_training_inplace(model: nn.Module, include_keys: list[str] | None = None,
                              exclude_keys: list[str] | None = None) -> int:
    """Swap every matching ``Linear`` (exactly that class) to
    ``Int8TrainLinear`` in place: the parameters stay, only the class
    changes. A path matches a key it contains. Returns the swap count."""
    include_keys = include_keys if include_keys is not None else [""]
    exclude_keys = exclude_keys or []
    n = 0
    for path, child in model.named_modules():
        if type(child) is not Linear:
            continue
        if not any(k in path for k in include_keys):
            continue
        if any(k in path for k in exclude_keys):
            continue
        child.__class__ = Int8TrainLinear
        n += 1
    return n
