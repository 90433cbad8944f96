"""Cross-JiT: the context enters through one cross-attention block instead
of the token sequence (port of
``vision_pt_tpu/models/jit/extension/cross.py``).

Sandwich-norm self-attention blocks over the image tokens (patches, size and
time tokens), with ONE cross-attention block at ``depth // 2`` whose queries
and keys take their own rotary tables and a (B, 1, Sq, Sk) mask. The
self-attention blocks carry neither kv_lens nor a mask, so on a CUDA device
they run the packed kernels (#1/#2) where the sequence is long enough; the
cross block runs the plain attention.

The cross block takes PoPE only under ``positional_encoding: pope``; under
``n-pope`` it applies RoPE to PoPE's full-dim table, which cannot broadcast,
and its forward raises, as the JAX package's does.
"""

from __future__ import annotations

import torch
from torch import nn

from ....ops.attention import dot_product_attention
from ....ops.norm import get_norm_layer
from ..config import DenoiserConfig, JiTConfig
from ..denoiser import Attention, JiT, SwiGLU, apply_rope
from ..pipeline import JiTModel
from .pope import PopeAttention
from .uvit import NormPosition, UJiTBlock, block_kwargs


def _cross_mask(query_mask, key_mask):
    """(B, Sq) x (B, Sk) -> (B, 1, Sq, Sk) bool, or None."""
    if query_mask is None or key_mask is None:
        return None
    return (query_mask.to(torch.bool)[:, None, :, None]
            & key_mask.to(torch.bool)[:, None, None, :])


class CrossAttention(Attention):
    """Cross-attention with separate query and key rotary tables. Under
    tensor parallelism ``to_q`` (over the image tokens) and ``to_k`` /
    ``to_v`` (over the context) are split by columns and ``to_o`` by rows,
    as in ``Attention``: each rank attends over its own heads."""

    def forward(self, hidden_states, key_value_states, query_rope_freqs,
                key_rope_freqs, query_mask=None, key_mask=None):
        b, sq, _ = hidden_states.shape
        q = self._split_heads(self.to_q(hidden_states))
        k = self._split_heads(self.to_k(key_value_states))
        v = self._split_heads(self.to_v(key_value_states))
        if self.q_norm is not None:
            q = self.q_norm(q)
            k = self.k_norm(k)
        q = apply_rope(q, query_rope_freqs)
        k = apply_rope(k, key_rope_freqs)
        mask = _cross_mask(query_mask, key_mask)
        attn = dot_product_attention(
            q, k, v, mask=mask, backend="xla" if mask is not None else "auto")
        return self.to_o(attn.to(hidden_states.dtype).reshape(b, sq, -1))


class PopeCrossAttention(PopeAttention):
    """PoPE cross-attention."""

    def forward(self, hidden_states, key_value_states, query_rope_freqs,
                key_rope_freqs, query_mask=None, key_mask=None):
        b, sq, _ = hidden_states.shape
        q = self._split_heads(self.to_q(hidden_states))
        k = self._split_heads(self.to_k(key_value_states))
        v = self._split_heads(self.to_v(key_value_states))
        q, k = self._pope_qk(q, k, query_rope_freqs, key_rope_freqs)
        mask = _cross_mask(query_mask, key_mask)
        attn = dot_product_attention(q, k, v, mask=mask, backend="xla")
        return self.to_o(attn.to(hidden_states.dtype).reshape(b, sq, -1))


class CrossJiTBlock(nn.Module):
    """Cross-attention + SwiGLU, with the image and the context normalized
    apart before the attention."""

    fsdp_unit = True  # gathered alone under FSDP (parallel.mesh)

    def __init__(self, hidden_dim, num_heads, mlp_ratio=4.0, qkv_bias=True,
                 qk_norm=True, use_bias=True, eps=1e-6,
                 positional_encoding="rope", norm_type="rms",
                 norm_position: NormPosition = "sandwich", attn_dropout=0.0,
                 proj_dropout=0.0, *, dtype=None, param_dtype=torch.float32,
                 generator=None):
        super().__init__()
        has_pre = norm_position in ("pre", "sandwich")
        has_post = norm_position in ("post", "sandwich")
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)

        def norm():
            return get_norm_layer(norm_type, hidden_dim, eps=eps,
                                  param_dtype=param_dtype)

        self.norm_attn_image_pre = norm() if has_pre else None
        self.norm_attn_post = norm() if has_post else None
        self.norm_attn_context_pre = norm() if has_pre else None
        attention_class = (PopeCrossAttention if positional_encoding == "pope"
                           else CrossAttention)
        self.attn = attention_class(
            dim=hidden_dim, num_heads=num_heads, qkv_bias=qkv_bias,
            qk_norm=qk_norm, attn_dropout=attn_dropout,
            proj_dropout=proj_dropout, norm_type="rms", **kw,
        )
        self.norm_mlp_pre = norm() if has_pre else None
        self.norm_mlp_post = norm() if has_post else None
        self.mlp = SwiGLU(hidden_dim, int(hidden_dim * mlp_ratio),
                          use_bias=use_bias, **kw)

    def forward(self, image_hidden_states, context_hidden_states,
                image_rope_freqs, context_rope_freqs, image_mask=None,
                context_mask=None):
        h = image_hidden_states
        a = self.norm_attn_image_pre(h) if self.norm_attn_image_pre is not None else h
        c = (self.norm_attn_context_pre(context_hidden_states)
             if self.norm_attn_context_pre is not None else context_hidden_states)
        a = self.attn(a, c, image_rope_freqs, context_rope_freqs,
                      query_mask=image_mask, key_mask=context_mask)
        if self.norm_attn_post is not None:
            a = self.norm_attn_post(a)
        h = h + a
        m = self.norm_mlp_pre(h) if self.norm_mlp_pre is not None else h
        m = self.mlp(m)
        if self.norm_mlp_post is not None:
            m = self.norm_mlp_post(m)
        return h + m


class CrossJiTDenoiserConfig(DenoiserConfig):
    norm_position: NormPosition = "sandwich"


class CrossJiT(JiT):
    """Self-attention blocks with the cross-attention block at depth // 2;
    ``context_start_block`` and ``do_context_fuse`` do not apply."""

    def _build_blocks(self, config: CrossJiTDenoiserConfig, **kw):
        bkw = block_kwargs(config, **kw)
        self.blocks = nn.ModuleList([
            CrossJiTBlock(**bkw) if i == config.depth // 2
            else UJiTBlock(has_skip_connection=False, **bkw)
            for i in range(config.depth)
        ])

    def forward(self, image, timestep, context, original_size, target_size,
                crop_coords, context_mask=None):
        height, width = image.shape[1], image.shape[2]
        (tokens, context_embed, freqs, _, _, patches_len,
         prefix_len) = self._prepare_inputs(
            image, timestep, context, original_size, target_size, crop_coords,
            context_mask,
        )
        context_len = context_embed.shape[1]
        image_freqs = freqs[:prefix_len]
        context_freqs = freqs[prefix_len:prefix_len + context_len]
        image_mask = ctx_mask = None
        if context_mask is not None:
            image_mask = torch.ones(tokens.shape[0], prefix_len,
                                    dtype=torch.bool, device=tokens.device)
            ctx_mask = context_mask.to(torch.bool)
        for block in self.blocks:
            if isinstance(block, CrossJiTBlock):
                tokens = self._run_block(block, tokens, context_embed,
                                         image_freqs, context_freqs,
                                         image_mask=image_mask,
                                         context_mask=ctx_mask)
            else:
                tokens = self._run_block(block, tokens, image_freqs)
        patches = self.final_layer(tokens[:, :patches_len, :])
        return self.unpatchify(patches, height, width)


class Denoiser(CrossJiT):
    pass


class CrossJiTConfig(JiTConfig):
    denoiser: CrossJiTDenoiserConfig = CrossJiTDenoiserConfig()


class CrossJiTModel(JiTModel):
    denoiser_class = Denoiser
