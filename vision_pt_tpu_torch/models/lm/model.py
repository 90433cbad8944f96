"""Decoder-only LM for text conditioning encoders (port of
``vision_pt_tpu/models/lm/model.py``).

Two towers in one module:

- ``glm`` (GLM-4, CogView4's text tower): GQA, partial interleaved rotary
  (each angle repeated for its pair), fused ``gate_up_proj``, q/k/v bias, no
  ``o_proj`` bias;
- ``qwen3`` (text-conditioned JiT): per-head q/k RMSNorm, full rotate-half
  rotary, split gate/up.

The module names are HF transformers' (``embed_tokens``,
``layers.N.self_attn.{q,k,v,o}_proj``, ``mlp.*``, ``input_layernorm``,
``post_attention_layernorm``, ``norm``), so the port's ``state_dict`` is the
HF layout and :func:`from_jax_state` takes either an HF state or the JAX
module's. Attention is a plain product: fp32 logits, a
``finfo(float32).min`` causal bias above the diagonal, GQA expanded by
repeating the key/value heads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import _exact_tf32
from ...ops.linear import Linear
from ...ops.norm import FP32RMSNorm
from ..sdxl.text_encoder import Embed


@dataclass
class DecoderLMConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0
    attention_bias: bool = False
    hidden_act: str = "silu"
    arch: str = "qwen3"  # "glm" | "qwen3"


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rotate_interleaved(x):
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def _apply_rotary(x, cos, sin, interleaved: bool):
    """x (B, S, H, D_rot); cos/sin (S, D_rot) fp32."""
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    rot = _rotate_interleaved(x) if interleaved else _rotate_half(x)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


def _linear(din, dout, use_bias, kw):
    return Linear(din, dout, use_bias=use_bias, std=None, **kw)


class Attention(nn.Module):
    def __init__(self, config: DecoderLMConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        c = self.config = config
        d = c.hidden_size
        self.rotary_dim = int(c.head_dim * c.partial_rotary_factor)
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.q_proj = _linear(d, c.num_attention_heads * c.head_dim,
                              c.attention_bias, kw)
        self.k_proj = _linear(d, c.num_key_value_heads * c.head_dim,
                              c.attention_bias, kw)
        self.v_proj = _linear(d, c.num_key_value_heads * c.head_dim,
                              c.attention_bias, kw)
        self.o_proj = _linear(c.num_attention_heads * c.head_dim, d, False, kw)
        self.q_norm = self.k_norm = None
        if c.arch == "qwen3":
            norm = dict(eps=c.rms_norm_eps, param_dtype=param_dtype)
            self.q_norm = FP32RMSNorm(c.head_dim, **norm)
            self.k_norm = FP32RMSNorm(c.head_dim, **norm)

    def forward(self, x, cos, sin, causal_bias):
        c = self.config
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, c.num_attention_heads, c.head_dim)
        k = self.k_proj(x).reshape(b, s, c.num_key_value_heads, c.head_dim)
        v = self.v_proj(x).reshape(b, s, c.num_key_value_heads, c.head_dim)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        rd, interleaved = self.rotary_dim, c.arch == "glm"
        q = torch.cat([_apply_rotary(q[..., :rd], cos, sin, interleaved),
                       q[..., rd:]], dim=-1)
        k = torch.cat([_apply_rotary(k[..., :rd], cos, sin, interleaved),
                       k[..., rd:]], dim=-1)
        groups = c.num_attention_heads // c.num_key_value_heads
        if groups > 1:  # GQA: expand the key/value heads
            k = k.repeat_interleave(groups, dim=2)
            v = v.repeat_interleave(groups, dim=2)
        with _exact_tf32(q.dtype, q.device):  # fp32 logits of q, k
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits * (c.head_dim**-0.5) + causal_bias
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, -1)
        return self.o_proj(out)


class MLP(nn.Module):
    def __init__(self, config: DecoderLMConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        c = config
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.arch = c.arch
        if c.arch == "glm":
            self.gate_up_proj = _linear(c.hidden_size, 2 * c.intermediate_size,
                                        False, kw)
        else:
            self.gate_proj = _linear(c.hidden_size, c.intermediate_size, False, kw)
            self.up_proj = _linear(c.hidden_size, c.intermediate_size, False, kw)
        self.down_proj = _linear(c.intermediate_size, c.hidden_size, False, kw)

    def forward(self, x):
        if self.arch == "glm":
            gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class DecoderLayer(nn.Module):
    def __init__(self, config: DecoderLMConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        norm = dict(eps=config.rms_norm_eps, param_dtype=param_dtype)
        self.self_attn = Attention(config, **kw)
        self.mlp = MLP(config, **kw)
        self.input_layernorm = FP32RMSNorm(config.hidden_size, **norm)
        self.post_attention_layernorm = FP32RMSNorm(config.hidden_size, **norm)

    def forward(self, x, cos, sin, causal_bias):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, causal_bias)
        return x + self.mlp(self.post_attention_layernorm(x))


class DecoderLMOutput(NamedTuple):
    last_hidden_state: torch.Tensor
    penultimate_hidden_state: torch.Tensor  # the state entering the last layer


class DecoderLM(nn.Module):
    def __init__(self, config: DecoderLMConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        self.config = c = config
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.embed_tokens = Embed(c.vocab_size, c.hidden_size, **kw)
        self.layers = nn.ModuleList(DecoderLayer(c, **kw)
                                    for _ in range(c.num_hidden_layers))
        self.norm = FP32RMSNorm(c.hidden_size, eps=c.rms_norm_eps,
                                param_dtype=param_dtype)

    def rope_tables(self, seq: int) -> tuple[np.ndarray, np.ndarray]:
        """(cos, sin) of shape (seq, rotary dim), fp32, from fp64 angles."""
        c = self.config
        rd = int(c.head_dim * c.partial_rotary_factor)
        inv_freq = 1.0 / (c.rope_theta ** (np.arange(0, rd, 2, dtype=np.float64) / rd))
        freqs = np.outer(np.arange(seq, dtype=np.float64), inv_freq)
        if c.arch == "glm":  # interleaved: each angle repeated for its pair
            emb = np.repeat(freqs, 2, axis=-1)
        else:
            emb = np.concatenate([freqs, freqs], axis=-1)
        return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)

    def forward(self, input_ids: torch.Tensor) -> DecoderLMOutput:
        seq, device = input_ids.shape[1], input_ids.device
        cos, sin = (torch.from_numpy(t).to(device) for t in self.rope_tables(seq))
        causal = torch.full((seq, seq), torch.finfo(torch.float32).min,
                            device=device).triu(1)
        x = self.embed_tokens(input_ids)
        penultimate = x
        for i, layer in enumerate(self.layers):
            if i == len(self.layers) - 1:
                penultimate = x
            x = layer(x, cos, sin, causal)
        return DecoderLMOutput(last_hidden_state=self.norm(x),
                               penultimate_hidden_state=penultimate)


def from_jax_state(flat: dict) -> dict[str, torch.Tensor]:
    """The JAX module's parameters (``flatten_state`` keys, as numpy) or an
    HF transformers state (``model.`` prefix optional, ``lm_head`` dropped)
    -> the port's ``state_dict``: a linear ``kernel`` (in, out) becomes
    ``weight`` (out, in), the embedding table ``embed_tokens.weight``, and a
    bare RMSNorm scale (``norm``, ``layers.N.input_layernorm``,
    ``...q_norm``) its ``.weight``."""
    out: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        value = np.asarray(value)
        key = key.removeprefix("model.")
        if key.startswith("lm_head."):
            continue
        if key.endswith(".kernel"):
            key, value = key[: -len(".kernel")] + ".weight", value.T
        elif key.endswith(".embedding"):
            key = key[: -len(".embedding")] + ".weight"
        elif not key.endswith((".weight", ".bias")):
            key = key + ".weight"
        out[key] = torch.from_numpy(np.array(value))
    return out
