"""TREAD token routing, a training-time compute cut (port of
``vision_pt_tpu/models/jit/extension/tread.py``).

Between ``tread_start_block`` and ``tread_end_block`` only a random subset
of the patch tokens goes through the blocks; the others rejoin through the
inverse permutation at ``tread_end_block``. The token layout is
[patches, size and time tokens, context], with the context in every block
(reset to its embedding unless ``do_context_fuse``), and the right-padded
context reaches each block as suffix ``kv_lens`` with no mask, so blocks
whose sequence the packed gate admits run kernels #1/#2.

The permutation is an input (``route_perm``), drawn by the workload from
its ``torch.Generator``: the JAX package draws it inside the denoiser from
a route key, whose bits no other framework reproduces. Without it (sampling)
every block sees every token.
"""

from __future__ import annotations

import torch

from ..config import DenoiserConfig, JiTConfig
from ..denoiser import JiT
from ..pipeline import JiTModel


class JiTWithTreadDenoiserConfig(DenoiserConfig):
    tread_route_rate: float = 0.5  # fraction of patch tokens KEPT
    tread_start_block: int = 2
    tread_end_block: int = 8


class JiTWithTread(JiT):
    config: JiTWithTreadDenoiserConfig

    def __init__(self, config: JiTWithTreadDenoiserConfig, **kwargs):
        if not config.tread_start_block < config.tread_end_block <= config.depth:
            raise ValueError("TREAD needs tread_start_block < tread_end_block <= depth")
        super().__init__(config, **kwargs)
        self.use_tread = config.tread_route_rate > 0

    def num_patches(self, height: int, width: int) -> int:
        """The length of a ``route_perm`` for an image of this size."""
        p = self.config.patch_size
        return (height // p) * (width // p)

    def forward(self, image, timestep, context, original_size, target_size,
                crop_coords, context_mask=None,
                route_perm: torch.Tensor | None = None):
        """``route_perm``: a permutation of the patch indices; its first
        ``int(num_patches * tread_route_rate)`` entries are the tokens kept
        through the routed blocks."""
        cfg = self.config
        height, width = image.shape[1], image.shape[2]
        batch = image.shape[0]
        (tokens, context_embed, freqs, _, _, patches_len,
         prefix_len) = self._prepare_inputs(
            image, timestep, context, original_size, target_size, crop_coords,
            context_mask,
        )
        context_len = context_embed.shape[1]
        num_info = prefix_len - patches_len
        patch_tokens = tokens[:, :patches_len, :]
        info_tokens = tokens[:, patches_len:, :]
        context_tokens = context_embed
        patch_freqs = freqs[:patches_len]
        info_freqs = freqs[patches_len:prefix_len]
        context_freqs = freqs[prefix_len:prefix_len + context_len]
        if context_mask is not None:
            ctx_valid = context_mask.to(torch.int32).sum(dim=1)
        else:
            ctx_valid = torch.full((batch,), context_len, dtype=torch.int32,
                                   device=image.device)

        do_route = self.use_tread and route_perm is not None
        if do_route:
            perm = route_perm.to(image.device)
            num_keep = int(patches_len * cfg.tread_route_rate)
            keep_idx, route_idx = perm[:num_keep], perm[num_keep:]
            inverse_perm = torch.argsort(perm)

        for i, block in enumerate(self.blocks):
            if do_route and i == cfg.tread_start_block:
                route_patch_tokens = patch_tokens[:, route_idx]
                route_patch_freqs = patch_freqs[route_idx]
                patch_tokens = patch_tokens[:, keep_idx]
                patch_freqs = patch_freqs[keep_idx]
            elif do_route and i == cfg.tread_end_block:
                patch_tokens = torch.cat(
                    [patch_tokens, route_patch_tokens], dim=1)[:, inverse_perm]
                patch_freqs = torch.cat(
                    [patch_freqs, route_patch_freqs], dim=0)[inverse_perm]

            block_tokens = torch.cat([patch_tokens, info_tokens, context_tokens],
                                     dim=1)
            block_freqs = torch.cat([patch_freqs, info_freqs, context_freqs], dim=0)
            cur_patches = patch_tokens.shape[1]
            kv_lens = cur_patches + num_info + ctx_valid
            block_tokens = self._run_block(block, block_tokens, block_freqs,
                                           kv_lens=kv_lens)
            patch_tokens = block_tokens[:, :cur_patches, :]
            info_tokens = block_tokens[:, cur_patches:cur_patches + num_info, :]
            if cfg.do_context_fuse:
                context_tokens = block_tokens[:, -context_len:, :]
            else:
                context_tokens = context_embed

        patches = self.final_layer(patch_tokens)
        return self.unpatchify(patches, height, width)


class Denoiser(JiTWithTread):
    pass


class JiTWithTreadConfig(JiTConfig):
    denoiser: JiTWithTreadDenoiserConfig = JiTWithTreadDenoiserConfig()


class JiTWithTreadModel(JiTModel):
    denoiser_class = Denoiser
