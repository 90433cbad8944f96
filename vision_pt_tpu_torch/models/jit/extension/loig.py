"""Low-rank Internal Guidance JiT (port of
``vision_pt_tpu/models/jit/extension/loig.py``).

A second, rank-``internal_rank`` bottleneck final layer reads the LAST
hidden state; the forward returns (pred, weak_pred), and ``generate``
blends them as IG does.
"""

from __future__ import annotations

import torch

from ..config import DenoiserConfig, JiTConfig
from ..denoiser import BottleneckFinalLayer, JiT
from ..pipeline import JiTModel
from .ig import IGGenerateMixin


class LoIGJiTDenoiserConfig(DenoiserConfig):
    internal_rank: int = 16


class LoIGJiT(JiT):
    """JiT with the weak head ``low_rank_final_layer``."""

    def __init__(self, config: LoIGJiTDenoiserConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None, device="cpu"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype,
                         generator=generator, device="cpu")
        self.low_rank_final_layer = BottleneckFinalLayer(
            config.hidden_size, config.internal_rank, config.patch_size,
            config.out_channels, norm_type="rms", dtype=dtype,
            param_dtype=param_dtype, generator=generator,
        )
        self.to(device)

    def forward(self, image, timestep, context, original_size, target_size,
                crop_coords, context_mask=None):
        height, width = image.shape[1], image.shape[2]
        patches, _ = self._trunk(image, timestep, context, original_size,
                                 target_size, crop_coords, context_mask)
        pred = self.unpatchify(self.final_layer(patches), height, width)
        weak = self.unpatchify(self.low_rank_final_layer(patches), height, width)
        return pred, weak


class Denoiser(LoIGJiT):
    pass


class LoIGJiTConfig(JiTConfig):
    denoiser: LoIGJiTDenoiserConfig = LoIGJiTDenoiserConfig()


class LoIGJiTModel(IGGenerateMixin, JiTModel):
    denoiser_class = Denoiser
