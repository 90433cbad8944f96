"""``nnx.Linear`` and ``nnx.Conv`` semantics in torch.

Weights live in ``param_dtype``. With ``dtype`` set, the input, weight and
bias are all cast to it first; otherwise the computation runs in the promoted
dtype of input and weight. Weights are drawn from ``generator`` (normal with
``std``; None is 1/sqrt(fan_in), the variance of ``nnx``'s default init),
biases are zero. Parameters are created on the current default device, so a
model built under ``with torch.device("cuda")`` with a CUDA generator never
touches the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _init_(weight: torch.Tensor, fan_in: int, std: float | None, generator):
    with torch.no_grad():
        weight.normal_(0.0, fan_in**-0.5 if std is None else std,
                       generator=generator)


class Linear(nn.Module):
    """Weight (out, in) in ``param_dtype``; the default init is the JiT
    reference's normal(0.02)."""

    def __init__(self, din: int, dout: int, *, use_bias: bool = True,
                 dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 std: float | None = 0.02):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dout, din, dtype=param_dtype))
        self.bias = (
            nn.Parameter(torch.zeros(dout, dtype=param_dtype)) if use_bias else None
        )
        _init_(self.weight, din, std, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Module):
    """A 2-D convolution over NHWC tensors (the JAX package's layout); the
    weight is torch's (out, in, kh, kw). ``padding`` is an int (both sides)
    or ((top, bottom), (left, right))."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int | tuple = 0, *, use_bias: bool = True,
                 dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 std: float | None = None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        if isinstance(padding, int):
            padding = ((padding, padding), (padding, padding))
        (top, bottom), (left, right) = padding
        self.symmetric = top == bottom and left == right
        self.pad = (top, left) if self.symmetric else (left, right, top, bottom)
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kernel, kernel, dtype=param_dtype))
        self.bias = (nn.Parameter(torch.zeros(cout, dtype=param_dtype))
                     if use_bias else None)
        _init_(self.weight, cin * kernel * kernel, std, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        x = x.to(dt).permute(0, 3, 1, 2)
        bias = self.bias.to(dt) if self.bias is not None else None
        if self.symmetric:
            y = F.conv2d(x, self.weight.to(dt), bias, self.stride, self.pad)
        else:
            y = F.conv2d(F.pad(x, self.pad), self.weight.to(dt), bias, self.stride)
        return y.permute(0, 2, 3, 1)
