"""U-JiT: U-ViT-style long skips (arXiv 2209.12152) (port of
``vision_pt_tpu/models/jit/extension/uvit.py``).

Down, mid, up and out block lists; each up block merges the skip of its
mirror down block through ``skip_merge`` over the concatenation
``[h, skip]``. Blocks take pre, post or sandwich norms. The context is
appended before and stripped after every block (or fused once with
``do_context_fuse``), and the skips are recorded with it. Every block
carries the key mask, so every block runs the plain attention, as in the
JAX package.
"""

from __future__ import annotations

from typing import Literal

import torch
from torch import nn

from ....ops.linear import Linear
from ....ops.norm import get_norm_layer
from ..config import DenoiserConfig, JiTConfig
from ..denoiser import JiT, SwiGLU, attention_class_for
from ..pipeline import JiTModel

NormPosition = Literal["pre", "post", "sandwich"]


class UJiTBlock(nn.Module):
    """Attention + SwiGLU with pre, post or sandwich norms and an optional
    concat-skip merge; the attention's q/k norms are always RMS."""

    fsdp_unit = True  # gathered alone under FSDP (parallel.mesh)

    def __init__(self, hidden_dim, num_heads, mlp_ratio=4.0, qkv_bias=True,
                 qk_norm=True, use_bias=True, has_skip_connection=False,
                 eps=1e-6, positional_encoding="rope", norm_type="rms",
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

        self.skip_merge = (Linear(hidden_dim * 2, hidden_dim, use_bias=use_bias, **kw)
                           if has_skip_connection else None)
        self.norm_attn_pre = norm() if has_pre else None
        self.norm_attn_post = norm() if has_post else None
        self.attn = attention_class_for(positional_encoding)(
            dim=hidden_dim, num_heads=num_heads, qkv_bias=qkv_bias,
            qk_norm=qk_norm, attn_dropout=attn_dropout,
            proj_dropout=proj_dropout, norm_type="rms", **kw,
        )
        self.norm_mlp_pre = norm() if has_pre else None
        self.norm_mlp_post = norm() if has_post else None
        self.mlp = SwiGLU(hidden_dim, int(hidden_dim * mlp_ratio),
                          use_bias=use_bias, **kw)

    def forward(self, hidden_states, rope_freqs, skip_hidden_states=None,
                kv_lens=None, key_mask=None):
        if skip_hidden_states is not None:
            hidden_states = self.skip_merge(
                torch.cat([hidden_states, skip_hidden_states], dim=-1))
        h = hidden_states
        a = self.norm_attn_pre(h) if self.norm_attn_pre is not None else h
        a = self.attn(a, rope_freqs, kv_lens=kv_lens, key_mask=key_mask)
        if self.norm_attn_post is not None:
            a = self.norm_attn_post(a)
        h = h + a
        m = self.norm_mlp_pre(h) if self.norm_mlp_pre is not None else h
        m = self.mlp(m)
        if self.norm_mlp_post is not None:
            m = self.norm_mlp_post(m)
        return h + m


class UJiTDenoiserConfig(DenoiserConfig):
    num_blocks: int = 12
    norm_position: NormPosition = "sandwich"


def block_kwargs(config: DenoiserConfig, **kw) -> dict:
    """The keyword arguments every U-JiT / Cross-JiT block takes."""
    return dict(
        hidden_dim=config.hidden_size, num_heads=config.num_heads,
        mlp_ratio=config.mlp_ratio, attn_dropout=config.attn_dropout,
        proj_dropout=config.proj_dropout, qkv_bias=True, qk_norm=True,
        use_bias=True, eps=1e-6,
        positional_encoding=config.positional_encoding,
        norm_type=config.norm_type, norm_position=config.norm_position, **kw,
    )


class UJiT(JiT):
    """``depth`` down blocks record the full tokens (context included) as
    skips; ``depth`` up blocks merge them in reverse; then
    ``num_blocks - (2 * depth + 1)`` out blocks."""

    def _build_blocks(self, config: UJiTDenoiserConfig, **kw):
        depth = config.depth
        num_out = config.num_blocks - (depth * 2 + 1)
        if num_out < 0:
            raise ValueError("num_blocks must be at least depth * 2 + 1")
        bkw = block_kwargs(config, **kw)
        self.down_blocks = nn.ModuleList(
            [UJiTBlock(has_skip_connection=False, **bkw) for _ in range(depth)])
        self.mid_block = UJiTBlock(has_skip_connection=False, **bkw)
        self.up_blocks = nn.ModuleList(
            [UJiTBlock(has_skip_connection=True, **bkw) for _ in range(depth)])
        self.out_blocks = nn.ModuleList(
            [UJiTBlock(has_skip_connection=False, **bkw) for _ in range(num_out)])
        self.blocks = None

    def _ujit_block(self, block, tokens, context_embed, freqs, kv_lens,
                    key_mask, skip_tokens=None):
        """Append the context, run, keep the full tokens, strip the context."""
        fuse = self.config.do_context_fuse
        if not fuse:
            tokens = torch.cat([tokens, context_embed], dim=1)
        seq = tokens.shape[1]
        tokens = self._run_block(
            block, tokens, freqs[:seq], skip_hidden_states=skip_tokens,
            kv_lens=kv_lens,
            key_mask=key_mask[:, :seq] if key_mask is not None else None,
        )
        full = tokens
        if not fuse:
            tokens = tokens[:, :-context_embed.shape[1], :]
        return tokens, full

    def forward(self, image, timestep, context, original_size, target_size,
                crop_coords, context_mask=None):
        height, width = image.shape[1], image.shape[2]
        (tokens, context_embed, freqs, kv_lens, key_mask,
         patches_len, _) = self._prepare_inputs(
            image, timestep, context, original_size, target_size, crop_coords,
            context_mask,
        )
        if self.config.do_context_fuse:
            tokens = torch.cat([tokens, context_embed], dim=1)
        args = (context_embed, freqs, kv_lens, key_mask)
        skips = []
        for block in self.down_blocks:
            tokens, full = self._ujit_block(block, tokens, *args)
            skips.append(full)
        tokens, _ = self._ujit_block(self.mid_block, tokens, *args)
        for block in self.up_blocks:
            tokens, _ = self._ujit_block(block, tokens, *args,
                                         skip_tokens=skips.pop())
        for block in self.out_blocks:
            tokens, _ = self._ujit_block(block, tokens, *args)
        patches = self.final_layer(tokens[:, :patches_len, :])
        return self.unpatchify(patches, height, width)


class Denoiser(UJiT):
    pass


class UJiTConfig(JiTConfig):
    denoiser: UJiTDenoiserConfig = UJiTDenoiserConfig()


class UJiTModel(JiTModel):
    denoiser_class = Denoiser
