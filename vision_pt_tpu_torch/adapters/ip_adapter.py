"""IP-Adapter: decoupled image cross-attention (port of
``vision_pt_tpu/adapters/ip_adapter.py``).

Variants: original, adaln_zero, tanh_gate, gate, flamingo (a scalar tanh
gate), time_gate, peft (LoRA over the image projections). Each replaces an
SDXL ``attn2``: the text attention runs as before through the original
(frozen) projections, and the image tokens are attended through
``to_k_ip`` / ``to_v_ip``, raw (in, out) matrices without bias, added with
``ip_scale``. The new parameters are ``AdapterParam``, so adapter-only
training takes them through the PEFT filter. The adapter file keeps the
torch layout, ``to_k_ip.weight`` (out, in).
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch
from pydantic import BaseModel
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.linear import Linear
from ..ops.norm import LayerNorm, SingleAdaLayerNormZero
from ..peft.config import PeftConfigUnion, RegexMatch
from ..peft.functional import AdapterParam, linear_features, retype_to_adapter_params
from ..utils.dtype import str_to_dtype
from .util import Adapter, AdapterManager

IPAdapterVariant = Literal[
    "original", "adaln_zero", "peft", "tanh_gate", "gate", "flamingo",
    "time_gate",
]


class ImageEncoderConfig(BaseModel):
    type: str = "transformers"  # "transformers" | "timm"
    model_name: str = "openai/clip-vit-large-patch14"
    feature_dim: int = 1024
    weights_path: str | None = None
    feature_type: str = "pooler_output"  # "hidden_state" | "pooler_output"
    hidden_state_index: int = -1
    # timm towers only: the head count is not recoverable from fused-qkv
    # weights (the embed_dim // 64 default is wrong for e.g. ViT-H/14's 16
    # heads of 80), so set it for such towers
    num_heads: int | None = None


class IPAdapterConfig(BaseModel):
    variant: IPAdapterVariant = "original"
    ip_scale: float = 1.0
    num_ip_tokens: int = 4
    skip_zero_tokens: bool = False
    attn_renorm: bool = False
    dtype: str = "bfloat16"
    checkpoint_weight: str | None = None

    image_encoder: ImageEncoderConfig = ImageEncoderConfig()
    image_size: int = 224
    background_color: int = 255
    color_channel: str = "rgb"
    image_mean: list[float] = [0.48145466, 0.4578275, 0.40821073]
    image_std: list[float] = [0.26862954, 0.26130258, 0.27577711]

    peft: PeftConfigUnion | None = None
    time_embedding_dim: int = 1280


def to_tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


class ImageProjector(nn.Module):
    """Pooled image feature -> N context tokens (Linear + LayerNorm)."""

    def __init__(self, image_embed_dim: int, context_dim: int, num_ip_tokens: int,
                 *, dtype=None, param_dtype=torch.float32, generator=None):
        super().__init__()
        self.num_ip_tokens = num_ip_tokens
        self.context_dim = context_dim
        self.proj = Linear(image_embed_dim, num_ip_tokens * context_dim, dtype=dtype,
                           param_dtype=param_dtype, generator=generator, std=None)
        self.norm = LayerNorm(context_dim, dtype=dtype, param_dtype=param_dtype)
        retype_to_adapter_params(self)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        tokens = self.proj(image_embeds).reshape(
            image_embeds.shape[0], self.num_ip_tokens, self.context_dim)
        return self.norm(tokens)


class TanhGate(nn.Module):
    """Zero-init tanh gate."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = AdapterParam(torch.zeros(dim, dtype=torch.float32))

    def forward(self, x):
        return x * torch.tanh(self.weight).to(x.dtype)


class Gate(nn.Module):
    """Zero-init multiplicative gate."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = AdapterParam(torch.zeros(dim, dtype=torch.float32))

    def forward(self, x):
        return x * self.weight.to(x.dtype)


class IPAdapterCrossAttention(Adapter):
    """Decoupled image cross-attention on an SDXL ``attn2``: the original
    (possibly quantized or LoRA-wrapped) q/k/v/out, and ``to_k_ip`` /
    ``to_v_ip`` started from copies of a dense ``to_k`` / ``to_v`` (small
    normal draws, less 0.01, from ``generator`` otherwise)."""

    target_key: RegexMatch = RegexMatch(regex=r".*?(denoiser|diffusion_model).*\.attn2$")
    variant: IPAdapterVariant = "original"

    def __init__(self, cross_attention_dim: int, num_heads: int, head_dim: int,
                 to_q, to_k, to_v, to_out, config: IPAdapterConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cross_attention_dim = cross_attention_dim
        self.inner_dim = num_heads * head_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.ip_scale = config.ip_scale
        self.num_ip_tokens = config.num_ip_tokens
        self.attn_renorm = config.attn_renorm
        self.to_q, self.to_k, self.to_v, self.to_out = to_q, to_k, to_v, to_out

        dtype = str_to_dtype(config.dtype)
        device = linear_features(to_k)[2]
        if isinstance(to_k, (Linear, nn.Linear)):
            k_init = to_k.weight.detach().T.to(dtype)
            v_init = to_v.weight.detach().T.to(dtype)
        else:
            shape = (cross_attention_dim, self.inner_dim)
            k_init, v_init = (
                torch.randn(shape, generator=generator, device=device).to(dtype) * 0.01
                - 0.01 for _ in range(2))
        self.to_k_ip = AdapterParam(k_init.contiguous().clone())
        self.to_v_ip = AdapterParam(v_init.contiguous().clone())
        with torch.device(device):
            self._init_extra(config, generator)

    def _init_extra(self, config: IPAdapterConfig, generator):
        pass

    def get_adapter_state(self) -> dict[str, torch.Tensor]:
        """to_k_ip / to_v_ip as (out, in), and the variant's own weights."""
        out = {"to_k_ip.weight": _host(self.to_k_ip.T),
               "to_v_ip.weight": _host(self.to_v_ip.T)}
        out.update(self._extra_state())
        return out

    @torch.no_grad()
    def load_adapter_state(self, sd: dict) -> None:
        if (w := sd.get("to_k_ip.weight")) is not None:
            self.to_k_ip.copy_(to_tensor(w).T)
        if (w := sd.get("to_v_ip.weight")) is not None:
            self.to_v_ip.copy_(to_tensor(w).T)
        self._load_extra_state(sd)

    def _extra_state(self) -> dict[str, torch.Tensor]:
        return {}

    def _load_extra_state(self, sd: dict) -> None:
        pass

    @classmethod
    def from_module(cls, module, config: IPAdapterConfig, *,
                    generator: torch.Generator | None = None):
        return cls(cross_attention_dim=linear_features(module.to_k)[0],
                   num_heads=module.num_heads, head_dim=module.head_dim,
                   to_q=module.to_q, to_k=module.to_k, to_v=module.to_v,
                   to_out=module.to_out, config=config, generator=generator)

    # ----------------------------------------------------------- forward

    def _attend(self, query, key, value, mask=None):
        b, s, _ = query.shape
        sk = key.shape[1]
        q = query.reshape(b, s, self.num_heads, self.head_dim)
        k = key.reshape(b, sk, self.num_heads, self.head_dim)
        v = value.reshape(b, sk, self.num_heads, self.head_dim)
        attn = dot_product_attention(q, k, v, mask=mask)
        return attn.to(query.dtype).reshape(b, s, self.inner_dim)

    @staticmethod
    def _renorm(original, new):
        o = torch.linalg.vector_norm(original, dim=-1, keepdim=True)
        n = torch.linalg.vector_norm(new, dim=-1, keepdim=True)
        return new * (o / torch.clamp_min(n, 1e-12))

    def _ip_kv(self, ip_tokens):
        dt = self.to_k_ip.dtype
        return ip_tokens.to(dt) @ self.to_k_ip, ip_tokens.to(dt) @ self.to_v_ip

    def _gate(self, ip_hidden_states, time_embedding):
        return ip_hidden_states  # the gated variants override

    def forward(self, query, context, mask=None, time_embedding=None,
                ip_tokens=None, ip_mask=None, **kwargs):
        q = self.to_q(query)
        hidden_states = self._attend(q, self.to_k(context), self.to_v(context), mask=mask)
        if ip_tokens is not None:
            ip_k, ip_v = self._ip_kv(ip_tokens)
            ip_hidden = self._attend(q, ip_k.to(q.dtype), ip_v.to(q.dtype), mask=ip_mask)
            ip_hidden = self._gate(ip_hidden, time_embedding)
            new = hidden_states + self.ip_scale * ip_hidden
            hidden_states = self._renorm(hidden_states, new) if self.attn_renorm else new
        return self.to_out(hidden_states)


def _linear_state(prefix: str, linear: Linear) -> dict[str, torch.Tensor]:
    """A linear in the JAX package's own layout (``kernel`` (in, out))."""
    return {f"{prefix}.kernel": _host(linear.weight.T), f"{prefix}.bias": _host(linear.bias)}


class IPAdapterCrossAttentionAdaLNZero(IPAdapterCrossAttention):
    """The image tokens modulated by AdaLN-Zero of the time embedding; without
    ``ip_tokens`` they arrive as the context's tail."""

    variant = "adaln_zero"

    def _init_extra(self, config, generator):
        self.norm = SingleAdaLayerNormZero(
            hidden_dim=self.cross_attention_dim, gate_dim=self.inner_dim,
            embedding_dim=config.time_embedding_dim)
        retype_to_adapter_params(self.norm)

    def forward(self, query, context, mask=None, time_embedding=None,
                ip_tokens=None, ip_mask=None, **kwargs):
        if time_embedding is None:
            raise ValueError("the adaln_zero IP-Adapter needs time_embedding")
        if ip_tokens is None:
            ip_tokens = context[:, -self.num_ip_tokens:, :]
            context = context[:, : -self.num_ip_tokens, :]
        q = self.to_q(query)
        hidden_states = self._attend(q, self.to_k(context), self.to_v(context), mask=mask)
        normed_ip, _scale, _shift, gate = self.norm(ip_tokens, time_embedding)
        ip_k, ip_v = self._ip_kv(normed_ip)
        ip_hidden = self._attend(q, ip_k.to(q.dtype), ip_v.to(q.dtype))
        ip_hidden = ip_hidden * gate[:, None, :].to(ip_hidden.dtype)
        return self.to_out(hidden_states + self.ip_scale * ip_hidden)

    def _extra_state(self):
        # the JAX package writes this variant's norm in its own layout
        return {**_linear_state("norm.scale_shift", self.norm.scale_shift),
                **_linear_state("norm.gate", self.norm.gate)}

    @torch.no_grad()
    def _load_extra_state(self, sd):
        for name in ("scale_shift", "gate"):
            linear = getattr(self.norm, name)
            if (w := sd.get(f"norm.{name}.kernel")) is not None:
                linear.weight.copy_(to_tensor(w).T)
            if (b := sd.get(f"norm.{name}.bias")) is not None:
                linear.bias.copy_(to_tensor(b))


class IPAdapterCrossAttentionTanhGate(IPAdapterCrossAttention):
    variant = "tanh_gate"

    def _init_extra(self, config, generator):
        self.tanh_gate = TanhGate(self.inner_dim)

    def _gate(self, ip_hidden_states, time_embedding):
        return self.tanh_gate(ip_hidden_states)

    def _extra_state(self):
        return {"tanh_gate.weight": _host(self.tanh_gate.weight)}

    @torch.no_grad()
    def _load_extra_state(self, sd):
        if (w := sd.get("tanh_gate.weight")) is not None:
            self.tanh_gate.weight.copy_(to_tensor(w))


class IPAdapterCrossAttentionGate(IPAdapterCrossAttention):
    variant = "gate"

    def _init_extra(self, config, generator):
        self.gate = Gate(self.inner_dim)

    def _gate(self, ip_hidden_states, time_embedding):
        return self.gate(ip_hidden_states)

    def _extra_state(self):
        return {"gate.weight": _host(self.gate.weight)}

    @torch.no_grad()
    def _load_extra_state(self, sd):
        if (w := sd.get("gate.weight")) is not None:
            self.gate.weight.copy_(to_tensor(w))


class IPAdapterCrossAttentionFlamingoGate(IPAdapterCrossAttentionTanhGate):
    """A scalar tanh gate."""

    variant = "flamingo"

    def _init_extra(self, config, generator):
        self.tanh_gate = TanhGate(1)


class IPAdapterCrossAttentionTimeGate(IPAdapterCrossAttention):
    """A zero-init Linear(time embedding) gate; raw (in, out) kernel."""

    variant = "time_gate"

    def _init_extra(self, config, generator):
        self.time_gate_kernel = AdapterParam(
            torch.zeros(config.time_embedding_dim, self.inner_dim))
        self.time_gate_bias = AdapterParam(torch.zeros(self.inner_dim))

    def _gate(self, ip_hidden_states, time_embedding):
        gate = time_embedding.float() @ self.time_gate_kernel + self.time_gate_bias
        return ip_hidden_states * gate[:, None, :].to(ip_hidden_states.dtype)

    def _extra_state(self):
        return {"time_gate.weight": _host(self.time_gate_kernel.T),
                "time_gate.bias": _host(self.time_gate_bias)}

    @torch.no_grad()
    def _load_extra_state(self, sd):
        if (w := sd.get("time_gate.weight")) is not None:
            self.time_gate_kernel.copy_(to_tensor(w).T)
        if (b := sd.get("time_gate.bias")) is not None:
            self.time_gate_bias.copy_(to_tensor(b))


class IPAdapterCrossAttentionPeft(IPAdapterCrossAttention):
    """LoRA over the image projections: fp32 bias-free linears holding
    to_k_ip / to_v_ip, each wrapped by a LoRA adapter."""

    variant = "peft"

    def _init_extra(self, config, generator):
        from ..peft.config import LoRAConfig
        from ..peft.lora import LoRALinear

        if config.peft is None:
            raise ValueError("the peft IP-Adapter variant needs a peft config")
        lora = LoRAConfig.model_validate(config.peft.model_dump())
        for name, matrix in (("to_k_ip_lora", self.to_k_ip), ("to_v_ip_lora", self.to_v_ip)):
            base = Linear(self.cross_attention_dim, self.inner_dim, use_bias=False,
                          generator=generator, std=None)
            with torch.no_grad():
                base.weight.copy_(matrix.T)
            setattr(self, name, LoRALinear(lora, base, generator=generator))

    def _ip_kv(self, ip_tokens):
        return self.to_k_ip_lora(ip_tokens), self.to_v_ip_lora(ip_tokens)

    def _extra_state(self):
        return {f"{name}.{k}": v
                for name, lora in (("to_k_ip", self.to_k_ip_lora),
                                   ("to_v_ip", self.to_v_ip_lora))
                for k, v in lora.get_adapter_weights().items()}

    def _load_extra_state(self, sd):
        for name, lora in (("to_k_ip", self.to_k_ip_lora), ("to_v_ip", self.to_v_ip_lora)):
            sub = {k[len(name) + 1:]: v for k, v in sd.items()
                   if k.startswith(name + ".") and k != f"{name}.weight"}
            if sub:
                lora.load_weights(sub)


_VARIANTS: dict[str, type[IPAdapterCrossAttention]] = {
    "original": IPAdapterCrossAttention,
    "adaln_zero": IPAdapterCrossAttentionAdaLNZero,
    "tanh_gate": IPAdapterCrossAttentionTanhGate,
    "gate": IPAdapterCrossAttentionGate,
    "flamingo": IPAdapterCrossAttentionFlamingoGate,
    "time_gate": IPAdapterCrossAttentionTimeGate,
    "peft": IPAdapterCrossAttentionPeft,
}


def get_ip_adapter_class(variant: IPAdapterVariant):
    try:
        return _VARIANTS[variant]
    except KeyError:
        raise ValueError(f"Unknown adapter variant: {variant}. Supported: "
                         f"{sorted(_VARIANTS)}") from None


class IPAdapterManager(AdapterManager):
    """The adapter manager, with the image projector's factory."""

    def __init__(self, adapter_class=None, adapter_config: IPAdapterConfig | None = None):
        config = adapter_config or IPAdapterConfig()
        super().__init__(adapter_class or get_ip_adapter_class(config.variant), config)

    def get_projector(self, attention_dim: int, *,
                      generator: torch.Generator | None = None) -> ImageProjector:
        return ImageProjector(
            image_embed_dim=self.adapter_config.image_encoder.feature_dim,
            context_dim=attention_dim,
            num_ip_tokens=self.adapter_config.num_ip_tokens, generator=generator)
