"""Normalization layers with fp32 statistics (port of
``vision_pt_tpu/ops/norm.py``): statistics and the affine transform are
computed in float32 and the result is cast back to the input dtype."""

from __future__ import annotations

from typing import Literal, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .linear import Linear

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


class AdaLayerNormZeroOutput(NamedTuple):
    hidden_states: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor
    gate: torch.Tensor


class SingleAdaLayerNormZero(nn.Module):
    """AdaLN-Zero: SiLU(time embedding) -> Linear -> (scale, shift) applied
    to the affine-free fp32 LayerNorm of the hidden states, and a separate
    Linear gate. Both projections start at zero, so the block starts as
    identity."""

    def __init__(self, hidden_dim: int, gate_dim: int, embedding_dim: int, *,
                 param_dtype: torch.dtype = torch.float32,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.norm = FP32LayerNorm(hidden_dim, elementwise_affine=False, eps=1e-6)
        self.scale_shift = Linear(embedding_dim, 2 * hidden_dim, dtype=dtype,
                                  param_dtype=param_dtype)
        self.gate = Linear(embedding_dim, gate_dim, dtype=dtype,
                           param_dtype=param_dtype)
        with torch.no_grad():
            for linear in (self.scale_shift, self.gate):
                linear.weight.zero_()

    def forward(self, hidden_states: torch.Tensor,
                time_embed: torch.Tensor) -> AdaLayerNormZeroOutput:
        normed = self.norm(hidden_states)
        t = F.silu(time_embed)
        scale, shift = self.scale_shift(t).chunk(2, dim=-1)
        gate = self.gate(t)
        out = normed * (1.0 + scale[:, None, :]) + shift[:, None, :]
        return AdaLayerNormZeroOutput(out.to(hidden_states.dtype), scale, shift, gate)


def _fast_stats(x32, dims):
    """fp32 mean and fast variance E[x^2] - E[x]^2, clipped at 0 (the
    ``nnx`` norms' statistics)."""
    mean = x32.mean(dim=dims, keepdim=True)
    var = torch.clamp_min(x32.square().mean(dim=dims, keepdim=True) - mean.square(), 0.0)
    return mean, var


class LayerNorm(nn.Module):
    """``nnx.LayerNorm`` over the last axis (default epsilon 1e-6):
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in fp32, cast to
    ``dtype`` (or to the promoted dtype of x and the parameters)."""

    def __init__(self, dim: int, *, eps: float = 1e-6,
                 dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype))

    def forward(self, x):
        x32 = x.float()
        mean, var = _fast_stats(x32, (-1,))
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight.float())
        y = y + self.bias.float()
        return y.to(self.dtype or torch.promote_types(x.dtype, self.weight.dtype))


class GroupNorm(nn.Module):
    """``nnx.GroupNorm`` over NHWC: statistics per (sample, group) over H, W
    and the group's channels, then LayerNorm's affine arithmetic."""

    def __init__(self, channels: int, groups: int = 32, *, eps: float = 1e-6,
                 dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groups, self.eps, self.dtype = groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=param_dtype))

    def forward(self, x):
        b, h, w, c = x.shape
        x32 = x.float()
        mean, var = _fast_stats(x32.reshape(b, h, w, self.groups, -1), (1, 2, 4))
        per_channel = (b, 1, 1, self.groups, c // self.groups)
        mean = mean.expand(per_channel).reshape(b, 1, 1, c)
        mul = torch.rsqrt(var + self.eps).expand(per_channel).reshape(b, 1, 1, c)
        y = (x32 - mean) * (mul * self.weight.float()) + self.bias.float()
        return y.to(self.dtype or torch.promote_types(x.dtype, self.weight.dtype))


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
