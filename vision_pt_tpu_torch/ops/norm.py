"""Normalization layers with fp32 statistics (port of
``vision_pt_tpu/ops/norm.py``): statistics and the affine transform are
computed in float32 and the result is cast back to the input dtype."""

from __future__ import annotations

from typing import Literal

import torch
from torch import nn

NormType = Literal["layer", "rms", "dyt", "derf"]


def fp32_layer_norm(x, weight=None, bias=None, eps: float = 1e-6):
    """LayerNorm over the last axis, computed in float32, cast back."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def fp32_rms_norm(x, weight=None, eps: float = 1e-6):
    """RMSNorm over the last axis, computed in float32, cast back."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


class FP32LayerNorm(nn.Module):
    def __init__(self, dim: int, *, elementwise_affine: bool = True,
                 use_bias: bool = True, eps: float = 1e-6,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = self.bias = None
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype))
            if use_bias:
                self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype))

    def forward(self, x):
        return fp32_layer_norm(x, self.weight, self.bias, self.eps)


class FP32RMSNorm(nn.Module):
    def __init__(self, dim: int, *, elementwise_affine: bool = True,
                 eps: float = 1e-6, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = (
            nn.Parameter(torch.ones(dim, dtype=param_dtype))
            if elementwise_affine else None
        )

    def forward(self, x):
        return fp32_rms_norm(x, self.weight, self.eps)


class DyTNorm(nn.Module):
    """Dynamic Tanh norm (DyT): tanh(alpha * x) * w + b, in promoted dtype."""

    def __init__(self, dim: int, *, elementwise_affine: bool = True,
                 alpha_init_value: float = 0.5,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), alpha_init_value, dtype=param_dtype))
        self.weight = self.bias = None
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype))
            self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype))

    def forward(self, x):
        y = torch.tanh(self.alpha * x)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y.to(x.dtype)


class DerfNorm(nn.Module):
    """Dynamic erf norm (Derf): erf(alpha * x + shift) * w + b."""

    def __init__(self, dim: int, *, elementwise_affine: bool = True,
                 alpha_init_value: float = 0.5, shift_init_value: float = 0.0,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), alpha_init_value, dtype=param_dtype))
        self.shift = nn.Parameter(torch.full((1,), shift_init_value, dtype=param_dtype))
        self.weight = self.bias = None
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype))
            self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype))

    def forward(self, x):
        y = torch.erf(self.alpha * x + self.shift)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y.to(x.dtype)


def get_norm_layer(norm_type: NormType, dim: int, *,
                   elementwise_affine: bool = True, eps: float = 1e-6,
                   alpha_init_value: float = 0.5, shift_init_value: float = 0.0,
                   param_dtype: torch.dtype = torch.float32) -> nn.Module:
    if norm_type == "layer":
        return FP32LayerNorm(dim, elementwise_affine=elementwise_affine,
                             eps=eps, param_dtype=param_dtype)
    if norm_type == "rms":
        return FP32RMSNorm(dim, elementwise_affine=elementwise_affine,
                           eps=eps, param_dtype=param_dtype)
    if norm_type == "dyt":
        return DyTNorm(dim, elementwise_affine=elementwise_affine,
                       alpha_init_value=alpha_init_value,
                       param_dtype=param_dtype)
    if norm_type == "derf":
        return DerfNorm(dim, elementwise_affine=elementwise_affine,
                        alpha_init_value=alpha_init_value,
                        shift_init_value=shift_init_value,
                        param_dtype=param_dtype)
    raise ValueError(f"Unsupported norm type: {norm_type}")
