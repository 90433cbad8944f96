"""Quantized linear layers (port of ``vision_pt_tpu/ops/quant/layers.py``).

Weights live packed on the device; the forward dequantizes on the fly. The
backward passes gradients to the input only: quantized base weights are
frozen (the QLoRA contract).

Storage layout: when ``in_features % 128 == 0`` and ``out_features % 8 == 0``
codes are kept in the dequant-matmul kernel's transposed deinterleaved
(in//2, out) layout with (in//64, out) scales (converted to and from bnb
packing at the checkpoint boundary); otherwise in flat bnb packing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .nf4 import (
    CODEBOOKS,
    QuantState4bit,
    dequantize_4bit,
    quantize_4bit_device,
    quantize_4bit_device_kernel_layout,
    state_from_bnb_dict,
    state_to_bnb_dict,
)
from .nf4_matmul import (
    BLOCK,
    dequant_matmul_4bit,
    kernel_supported,
    repack_bnb,
    repack_deinterleaved,
)

# Below this many x rows the product is weight-bound and goes to the fused
# dequant-matmul kernel; above it (the self-attention and feed-forward
# products of a 1024^2 UNet call, training batches) the weight is dequantized
# once and multiplied densely. Kept at the JAX package's value, which was
# tuned on a TPU and is not yet measured on an H100.
KERNEL_MAX_ROWS = 1024


def _on_cuda(x: torch.Tensor) -> bool:
    """Where the dequant-matmul kernel can run (the JAX gate's
    ``_on_tpu()``)."""
    return x.is_cuda


def _dequant_deint(packed_t, absmax_t, quant_type, dtype):
    """Dense dequant from the transposed deinterleaved layout -> (out, in)."""
    code = torch.from_numpy(CODEBOOKS[quant_type]).to(packed_t.device)
    p = packed_t.long()  # (in//2, out)
    w_t = torch.cat([code[(p >> 4) & 0x0F], code[p & 0x0F]], dim=0)  # (in, out)
    scales = absmax_t.float().repeat_interleave(BLOCK, dim=0)
    return (w_t * scales).to(dtype).T


def _dequant_dense(packed, absmax, quant_type, shape, dtype, layout):
    if layout == "kernel":
        return _dequant_deint(packed, absmax, quant_type, dtype)
    return dequantize_4bit(
        packed, QuantState4bit(absmax, shape, BLOCK, quant_type, "float32"),
        dtype=dtype,
    )


def _q4_product(x, packed, absmax, quant_type, shape, layout):
    rows = x.numel() // x.shape[-1]
    if layout == "kernel" and _on_cuda(x) and rows <= KERNEL_MAX_ROWS:
        return dequant_matmul_4bit(x, packed, absmax, quant_type)
    w = _dequant_dense(packed, absmax, quant_type, shape, x.dtype, layout)
    return F.linear(x, w)


class _Q4Matmul(torch.autograd.Function):
    """The JAX package's custom VJP: the forward is the quantized product,
    the backward ``g @ dequant(W)`` to the input only."""

    @staticmethod
    def forward(ctx, x, packed, absmax, quant_type, shape, layout):
        ctx.save_for_backward(packed, absmax)
        ctx.args = (quant_type, shape, layout)
        return _q4_product(x, packed, absmax, quant_type, shape, layout)

    @staticmethod
    def backward(ctx, g):
        packed, absmax = ctx.saved_tensors
        quant_type, shape, layout = ctx.args
        w = _dequant_dense(packed, absmax, quant_type, shape, g.dtype, layout)
        return g @ w, None, None, None, None, None


class QuantLinear4bit(nn.Module):
    """NF4/FP4 weight-only linear (bnb Linear4bit analog); computes in the
    input's dtype. ``packed`` and ``absmax`` are buffers."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, quant_type: str = "nf4",
                 blocksize: int = BLOCK):
        super().__init__()
        assert blocksize == BLOCK, "only the bnb default blocksize=64 is supported"
        self.in_features = in_features
        self.out_features = out_features
        self.quant_type = quant_type
        self.blocksize = BLOCK
        self.layout = "kernel" if kernel_supported(in_features, out_features) else "flat"
        n = out_features * in_features
        if self.layout == "kernel":
            packed = torch.zeros(in_features // 2, out_features, dtype=torch.uint8)
            absmax = torch.zeros(in_features // BLOCK, out_features)
        else:
            packed = torch.zeros(n // 2, 1, dtype=torch.uint8)
            absmax = torch.zeros(-(-n // BLOCK))
        self.register_buffer("packed", packed)
        self.register_buffer("absmax", absmax)
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def _set_from_bnb(self, packed_bnb: np.ndarray, absmax_flat: np.ndarray):
        shape = (self.out_features, self.in_features)
        packed_bnb = np.asarray(packed_bnb, dtype=np.uint8).reshape(-1, 1)
        absmax_flat = np.asarray(absmax_flat, dtype=np.float32).reshape(-1)
        if self.layout == "kernel":
            packed = repack_deinterleaved(packed_bnb, shape)
            absmax = np.ascontiguousarray(
                absmax_flat.reshape(self.out_features, self.in_features // BLOCK).T)
        else:
            packed, absmax = packed_bnb, absmax_flat
        device = self.packed.device
        self.packed = torch.from_numpy(np.array(packed)).to(device)
        self.absmax = torch.from_numpy(np.array(absmax)).to(device)

    def _get_bnb(self) -> tuple[np.ndarray, np.ndarray]:
        packed = self.packed.cpu().numpy()
        absmax = self.absmax.cpu().numpy()
        if self.layout == "kernel":
            return repack_bnb(packed), absmax.T.reshape(-1)
        return packed, absmax

    @classmethod
    def from_linear(cls, linear: nn.Module, quant_type: str = "nf4",
                    blocksize: int = BLOCK) -> "QuantLinear4bit":
        """Quantize a linear's (out, in) weight on its own device."""
        weight = linear.weight.detach()
        out_dim, in_dim = weight.shape
        with torch.device(weight.device):
            module = cls(in_dim, out_dim, use_bias=linear.bias is not None,
                         quant_type=quant_type)
        if module.layout == "kernel":
            module.packed, module.absmax = quantize_4bit_device_kernel_layout(
                weight, quant_type, blocksize)
        else:
            packed, state = quantize_4bit_device(weight, blocksize, quant_type)
            module._set_from_bnb(packed, state.absmax)
        if linear.bias is not None:
            module.bias = nn.Parameter(linear.bias.detach().clone())
        return module

    def load_prequantized(self, packed: np.ndarray,
                          stats: dict[str, np.ndarray],
                          bias: np.ndarray | None = None):
        state = state_from_bnb_dict(stats)
        if state.shape != (self.out_features, self.in_features):
            raise ValueError(f"quant state shape {state.shape} mismatches layer "
                             f"({self.out_features}, {self.in_features})")
        if state.blocksize != BLOCK:
            raise ValueError(f"unsupported blocksize {state.blocksize}")
        self.quant_type = state.quant_type
        self._set_from_bnb(packed, state.absmax)
        if bias is not None:
            self.bias = nn.Parameter(
                torch.as_tensor(np.asarray(bias)).to(self.packed.device))

    def export_bnb(self, prefix: str = "") -> dict[str, np.ndarray]:
        """bnb-format tensors for checkpoint export ({prefix}weight + stats)."""
        packed, absmax = self._get_bnb()
        state = QuantState4bit(
            absmax=absmax, shape=(self.out_features, self.in_features),
            blocksize=BLOCK, quant_type=self.quant_type, dtype="float32",
        )
        out = {f"{prefix}weight": packed}
        out.update(state_to_bnb_dict(state, packed_prefix=f"{prefix}weight."))
        if self.bias is not None:
            out[f"{prefix}bias"] = self.bias.detach().cpu().numpy()
        return out

    def dequantized_kernel(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(in, out) dense kernel (for merging and debugging)."""
        return _dequant_dense(
            self.packed, self.absmax, self.quant_type,
            (self.out_features, self.in_features), dtype, self.layout,
        ).T

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _Q4Matmul.apply(
            x, self.packed, self.absmax, self.quant_type,
            (self.out_features, self.in_features), self.layout,
        )
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class QuantLinearInt8(nn.Module):
    """Per-output-channel symmetric int8 weight-only linear (bnb int8 /
    quanto qint8 analog)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.register_buffer(
            "qweight", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    @classmethod
    def from_linear(cls, linear: nn.Module) -> "QuantLinearInt8":
        w = linear.weight.detach().float()  # (out, in)
        scale = w.abs().amax(dim=1) / 127.0
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
        with torch.device(w.device):
            module = cls(w.shape[1], w.shape[0], use_bias=linear.bias is not None)
        module.qweight, module.scale = q, scale
        if linear.bias is not None:
            module.bias = nn.Parameter(linear.bias.detach().clone())
        return module

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.qweight.float() * self.scale[:, None]).to(x.dtype)
        y = F.linear(x, w)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class QuantLinearFP8(nn.Module):
    """fp8_e4m3 weight storage with a per-tensor scale."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.register_buffer(
            "qweight",
            torch.zeros(out_features, in_features, dtype=torch.float8_e4m3fn))
        self.register_buffer("scale", torch.ones(()))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    @classmethod
    def from_linear(cls, linear: nn.Module) -> "QuantLinearFP8":
        w = linear.weight.detach().float()  # (out, in)
        scale = max(float(w.abs().max()) / 448.0, 1e-12)
        with torch.device(w.device):
            module = cls(w.shape[1], w.shape[0], use_bias=linear.bias is not None)
        module.qweight = (w / scale).to(torch.float8_e4m3fn)
        module.scale = torch.tensor(scale, dtype=torch.float32, device=w.device)
        if linear.bias is not None:
            module.bias = nn.Parameter(linear.bias.detach().clone())
        return module

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.qweight.float() * self.scale).to(x.dtype)
        y = F.linear(x, w)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
