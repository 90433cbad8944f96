"""Internal Guidance JiT (arXiv 2512.24176) (port of
``vision_pt_tpu/models/jit/extension/ig.py``).

A second final layer reads the patch tokens after block
``intermediate_output_idx`` (context stripped); the forward returns
(pred, intermediate_pred). Guided sampling blends
``weak + ig_scale * (pred - weak)`` inside ``ig_time_range``, before CFG.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from ....utils import PromptType
from ....utils import tensor as tensor_utils
from ..config import DenoiserConfig, JiTConfig
from ..denoiser import BottleneckFinalLayer, FinalLayer, JiT
from ..pipeline import JiTModel


class IGJiTDenoiserConfig(DenoiserConfig):
    intermediate_output_idx: int = 4


def _make_final_layer(config: DenoiserConfig, **kw):
    if config.use_output_bottleneck:
        return BottleneckFinalLayer(config.hidden_size, config.bottleneck_dim,
                                    config.patch_size, config.out_channels,
                                    norm_type="rms", **kw)
    return FinalLayer(config.hidden_size, config.mlp_ratio, config.patch_size,
                      config.out_channels, eps=1e-6, norm_type="rms", **kw)


class IGJiT(JiT):
    """JiT with the intermediate head ``intermediate_final_layer``."""

    def __init__(self, config: IGJiTDenoiserConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None, device="cpu"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype,
                         generator=generator, device="cpu")
        self.intermediate_final_layer = _make_final_layer(
            config, dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.to(device)

    def forward(self, image, timestep, context, original_size, target_size,
                crop_coords, context_mask=None):
        height, width = image.shape[1], image.shape[2]
        idx = self.config.intermediate_output_idx
        patches, tapped = self._trunk(image, timestep, context, original_size,
                                      target_size, crop_coords, context_mask,
                                      taps=(idx,))
        pred = self.unpatchify(self.final_layer(patches), height, width)
        intermediate = None
        if idx in tapped:
            intermediate = self.unpatchify(
                self.intermediate_final_layer(tapped[idx]), height, width)
        return pred, intermediate


class Denoiser(IGJiT):
    pass


class IGJiTConfig(JiTConfig):
    denoiser: IGJiTDenoiserConfig = IGJiTDenoiserConfig()


class IGGenerateMixin:
    """``generate`` for guidance models whose denoiser returns
    (pred, weak_pred): the JAX package's per-step loop."""

    @torch.inference_mode()
    def generate(
        self,
        prompt: PromptType,
        negative_prompt: PromptType | None = None,
        width: int = 256,
        height: int = 256,
        num_inference_steps: int = 20,
        cfg_scale: float = 2.0,
        ig_scale: float = 1.0,
        max_token_length: int = 64,
        seed: int | None = None,
        execution_dtype: torch.dtype = torch.bfloat16,
        do_cfg_renorm: bool = False,
        do_dynamic_thresholding: bool = False,
        cfg_time_range: tuple[float, float] = (0.0, 1.0),
        ig_time_range: tuple[float, float] = (0.0, 1.0),
        initial_noise: torch.Tensor | np.ndarray | None = None,  # NHWC
        return_arrays: bool = False,
    ) -> list[Image.Image] | torch.Tensor:
        do_cfg = cfg_scale > 1.0
        do_ig = ig_scale > 1.0
        timesteps = self.prepare_timesteps(num_inference_steps)
        prompts = self.normalize_prompts(prompt)
        batch_size = len(prompts)
        if initial_noise is not None:
            noisy_image = torch.as_tensor(initial_noise).to(
                device=self.device, dtype=execution_dtype)
        else:
            noisy_image = self.prepare_noisy_image(
                batch_size, height, width, dtype=execution_dtype, seed=seed)
        negative_prompts = self.normalize_prompts(
            negative_prompt if negative_prompt is not None else [""])
        if len(negative_prompts) == 1 and batch_size > 1:
            negative_prompts = negative_prompts * batch_size
        prompt_embeddings, attention_mask = self.prepare_context_embeddings(
            prompts=prompts, negative_prompt=negative_prompts,
            max_token_length=max_token_length, do_cfg=do_cfg,
        )
        original_size, target_size, crop_coords = self.prepare_image_size_inputs(
            width, height, batch_size * 2 if do_cfg else batch_size,
            dtype=execution_dtype,
        )

        for i, t in enumerate(timesteps[:-1]):
            use_cfg = do_cfg and cfg_time_range[0] <= float(t) <= cfg_time_range[1]
            in_ig = ig_time_range[0] <= float(t) <= ig_time_range[1]
            image_input = torch.cat([noisy_image] * 2) if use_cfg else noisy_image
            model_pred, weak_pred = self._denoise(
                image_input, t, prompt_embeddings, attention_mask,
                original_size, target_size, crop_coords,
            )
            if do_ig and in_ig and weak_pred is not None:
                model_pred = weak_pred + ig_scale * (model_pred - weak_pred)
            t_arr = torch.tensor(t, dtype=torch.float32, device=self.device)
            if use_cfg:
                velocity = self.make_cfg_velocity_pred(
                    model_pred, noisy_image, t_arr, cfg_scale=cfg_scale,
                    do_cfg_renorm=do_cfg_renorm,
                    do_dynamic_thresholding=do_dynamic_thresholding,
                )
            else:
                velocity = self.make_velocity_pred(model_pred, noisy_image, t_arr)
            # a Python step size is weakly typed in JAX: it is rounded to the
            # image dtype before the multiply
            dt = torch.tensor(float(timesteps[i + 1] - t),
                              dtype=noisy_image.dtype, device=self.device)
            noisy_image = noisy_image + velocity.to(noisy_image.dtype) * dt

        if return_arrays:
            return noisy_image
        return tensor_utils.tensor_to_images(noisy_image)


class IGJiTModel(IGGenerateMixin, JiTModel):
    denoiser_class = Denoiser
