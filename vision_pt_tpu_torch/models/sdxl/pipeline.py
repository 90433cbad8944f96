"""SDXL pipeline: construction, checkpoint IO and Euler-ancestral CFG
sampling (port of ``vision_pt_tpu/models/sdxl/pipeline.py``).

Latents and images are NHWC at the public functions, as in the JAX package.
Everything runs on ``device``: the CUDA device unless the caller asks for
another. The model is built on that device from a generator on it, so a
full-size random model never takes a host round trip. Checkpoints speak the
original sgm single-file key layout through ``convert``.

One divergence from the JAX package: under CFG its sampler combines the
predictions with an fp32 guidance scale, which promotes bf16 latents to fp32
(the scanned loop then refuses the carry, the step-wise loop goes on in
fp32). The port rounds each step's latents back to the execution dtype.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from ...ops.quant.functional import load_state_with_prequantized
from ...utils import PromptType, resolve_device
from ...utils import tensor as tensor_utils
from ...utils.state_dict import (
    convert_open_clip_to_transformers,
    convert_transformers_to_open_clip,
)
from .config import SDXLConfig
from .convert import (
    convert_from_original_key,
    convert_to_original_key,
    fix_vae_attention_projections,
    port_to_torch_key,
    torch_to_port_key,
)
from .denoiser import Denoiser
from .scheduler import Scheduler
from .text_encoder import (
    TEXT_ENCODER_1_CONFIG,
    TEXT_ENCODER_2_CONFIG,
    CLIPTextConfig,
    CLIPTextModel,
    MultipleTextEncodingOutput,
    TextEncoder,
)
from .vae import DEFAULT_VAE_CONFIG, VAE

_TE1, _TE2 = "text_encoder.text_encoder_1.", "text_encoder.text_encoder_2."


class SDXLModel:
    """The UNet, the VAE and the two CLIP text encoders, on one device. A
    subclass swaps the UNet and the dual encoder through ``denoiser_class``
    and ``text_encoder_class``."""

    denoiser_class: type[Denoiser] = Denoiser
    text_encoder_class: type[TextEncoder] = TextEncoder

    def __init__(self, config: SDXLConfig, *, dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None,
                 tokenizer_1=None, tokenizer_2=None):
        self.config = config
        self.device = resolve_device(device)
        if dtype is None and config.torch_dtype != torch.float32:
            dtype = config.torch_dtype
        self._dtype = dtype
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        with self.device:
            self.denoiser = self.denoiser_class(config.denoiser, **kw).eval()
            self.vae = VAE(**(config.vae_config or DEFAULT_VAE_CONFIG), **kw).eval()
            c1 = (CLIPTextConfig(**config.text_encoder_1_config)
                  if config.text_encoder_1_config else TEXT_ENCODER_1_CONFIG)
            c2 = (CLIPTextConfig(**config.text_encoder_2_config)
                  if config.text_encoder_2_config else TEXT_ENCODER_2_CONFIG)
            self.text_encoder = self.text_encoder_class(
                CLIPTextModel(c1, **kw).eval(), tokenizer_1,
                CLIPTextModel(c2, with_projection=True, **kw).eval(), tokenizer_2,
            )
        self.scheduler = Scheduler()

    @classmethod
    def from_config(cls, config: SDXLConfig, seed: int = 0,
                    device: str | torch.device | None = None, **kw) -> "SDXLModel":
        """Random weights drawn from ``seed`` on ``device``."""
        device = resolve_device(device)
        return cls(config, generator=torch.Generator(device=device).manual_seed(seed),
                   device=device, **kw)

    def to(self, device: str | torch.device) -> "SDXLModel":
        """Move every module to ``device`` (in place)."""
        self.device = torch.device(device)
        for module in self._submodules().values():
            module.to(self.device)
        return self

    # ---------------------------------------------------------- checkpoint

    def _submodules(self) -> dict[str, torch.nn.Module]:
        return {"denoiser.": self.denoiser, "vae.": self.vae,
                _TE1: self.text_encoder.text_encoder_1,
                _TE2: self.text_encoder.text_encoder_2}

    def _load_checkpoint(self, checkpoint_path: str, strict: bool = True):
        """Load an sgm single-file checkpoint, plain or with linears
        prequantized in the bnb layout (``quantize_state_dict``)."""
        from safetensors.numpy import load_file

        sd = {convert_from_original_key(k): v
              for k, v in load_file(checkpoint_path).items()}
        parts = {prefix: {k[len(prefix):]: v for k, v in sd.items()
                          if k.startswith(prefix)}
                 for prefix in self._submodules()}
        parts[_TE1] = {k: v for k, v in parts[_TE1].items()
                       if ".embeddings.position_ids" not in k}
        parts[_TE2] = convert_open_clip_to_transformers(parts[_TE2])
        parts["vae."] = fix_vae_attention_projections(parts["vae."])
        for prefix, module in self._submodules().items():
            load_state_with_prequantized(
                module, {torch_to_port_key(k): v for k, v in parts[prefix].items()},
                strict=strict)

    @classmethod
    def from_checkpoint(cls, config: SDXLConfig, **kw) -> "SDXLModel":
        """Random init on the device, then the sgm single-file checkpoint at
        ``config.checkpoint_path`` loaded over it."""
        model = cls(config, **kw)
        model._load_checkpoint(config.checkpoint_path)
        return model

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The original sgm key layout, on the host. Quantized layers keep
        only their biases, as in the JAX package (its packed weights are not
        parameters)."""
        out: dict[str, torch.Tensor] = {}
        for prefix, module in self._submodules().items():
            torch_sd = {port_to_torch_key(k): v.detach().cpu().numpy()
                        for k, v in module.named_parameters()}
            if prefix == _TE2:
                torch_sd = convert_transformers_to_open_clip(torch_sd)
            for k, v in torch_sd.items():
                out[convert_to_original_key(prefix + k)] = torch.from_numpy(np.array(v))
        return out

    # ---------------------------------------------------------- latents/vae

    def prepare_latents(self, batch_size: int, height: int, width: int,
                        dtype: torch.dtype, max_noise_sigma: float,
                        seed: int | None = None,
                        latents: torch.Tensor | np.ndarray | None = None):
        if latents is not None:
            return torch.as_tensor(latents).to(self.device, dtype)
        shape = (batch_size, int(height) // self.vae.compression_ratio,
                 int(width) // self.vae.compression_ratio,
                 self.denoiser.config.in_channels)
        return tensor_utils.incremental_seed_randn(
            shape, seed=seed, dtype=dtype, device=self.device) * max_noise_sigma

    def encode_image(self, image, generator: torch.Generator | None = None):
        """PIL images or an NHWC array in [-1, 1] -> scaled latents."""
        if isinstance(image, (Image.Image, list)):
            images = image if isinstance(image, list) else [image]
            image = tensor_utils.images_to_tensor(images)
        tensor = torch.as_tensor(image).to(self.device, self._dtype or torch.float32)
        return self.vae.encode(tensor).sample(generator) * self.vae.scaling_factor

    def decode_image(self, latents: torch.Tensor,
                     use_tiling: bool = False) -> list[Image.Image]:
        return tensor_utils.tensor_to_images(self.decode_latents(latents, use_tiling))

    def decode_latents(self, latents: torch.Tensor,
                       use_tiling: bool = False) -> torch.Tensor:
        """Scaled latents -> NHWC images in [-1, 1]."""
        scaled = latents / self.vae.scaling_factor
        return self.vae.tiled_decode(scaled) if use_tiling else self.vae.decode(scaled)

    # ---------------------------------------------------------- text

    def prepare_timesteps(self, num_inference_steps: int):
        timesteps = self.scheduler.get_timesteps(num_inference_steps)
        return timesteps, self.scheduler.get_sigmas(timesteps)

    def prepare_encoder_hidden_states(self, encoder_output: MultipleTextEncodingOutput,
                                      do_cfg: bool):
        """CLIP-L (768) + bigG (1280) -> the 2048-wide context; pooled from
        bigG; [positive; negative] under CFG."""
        te1, te2 = encoder_output.text_encoder_1, encoder_output.text_encoder_2
        pos = torch.cat([te1.positive_embeddings, te2.positive_embeddings], dim=-1)
        if not do_cfg:
            return pos, te2.pooled_positive_embeddings
        neg = torch.cat([te1.negative_embeddings, te2.negative_embeddings], dim=-1)
        return (torch.cat([pos, neg], dim=0),
                torch.cat([te2.pooled_positive_embeddings,
                           te2.pooled_negative_embeddings], dim=0))

    # ---------------------------------------------------------- generate

    @torch.inference_mode()
    def generate(
        self,
        prompt: PromptType,
        negative_prompt: PromptType | None = None,
        width: int = 768,
        height: int = 768,
        original_size: tuple[int, int] | None = None,
        target_size: tuple[int, int] | None = None,
        crop_coords_top_left: tuple[int, int] = (0, 0),
        num_inference_steps: int = 20,
        cfg_scale: float = 3.5,
        max_token_length: int = 75,
        seed: int | None = None,
        execution_dtype: torch.dtype = torch.bfloat16,
        latents: torch.Tensor | np.ndarray | None = None,  # initial, NHWC
        step_noise: list | np.ndarray | None = None,  # per step, NHWC
        return_latents: bool = False,
        cross_attention_kwargs: dict | None = None,
        extra_context_tokens: torch.Tensor | None = None,
        _encode_prompts_kwargs: dict | None = None,
    ) -> list[Image.Image] | torch.Tensor:
        """Euler-ancestral sampling with CFG. ``latents`` and ``step_noise``
        replace the seeded draws (the initial latents, already scaled by the
        largest sigma, and each step's ancestral noise); otherwise the step
        noise comes from one generator seeded with ``seed``.
        ``cross_attention_kwargs`` go to every UNet call (an IP-Adapter's
        ``ip_tokens``); ``extra_context_tokens`` are appended to the text
        context (PFG's image tokens). Both are batched as the context is,
        [positive; negative] under CFG. ``_encode_prompts_kwargs`` go to the
        text encoder's ``encode_prompts`` (the style tokenizer's rows)."""
        do_cfg = cfg_scale > 1.0
        timesteps, sigmas = self.prepare_timesteps(num_inference_steps)
        batch_size = len(prompt) if isinstance(prompt, list) else 1
        original_size = original_size or (height, width)
        target_size = target_size or (height, width)
        should_tile = max(height, width) >= 1536

        encoder_output = self.text_encoder.encode_prompts(
            prompt, negative_prompt, use_negative_prompts=do_cfg,
            max_token_length=max_token_length, **(_encode_prompts_kwargs or {}))
        latents = self.prepare_latents(
            batch_size, height, width, execution_dtype,
            max_noise_sigma=self.scheduler.get_max_noise_sigma(sigmas),
            seed=seed, latents=latents)
        ehs, pooled = self.prepare_encoder_hidden_states(encoder_output, do_cfg)
        ehs, pooled = ehs.to(execution_dtype), pooled.to(execution_dtype)
        if extra_context_tokens is not None:
            ehs = torch.cat([ehs, extra_context_tokens.to(self.device, execution_dtype)],
                            dim=1)
        n = ehs.shape[0]

        def rows(pair):
            return torch.tensor(pair, dtype=torch.float32,
                                device=self.device).expand(n, 2)

        osz, tsz, crop = rows(original_size), rows(target_size), rows(crop_coords_top_left)
        generator = torch.Generator(device=self.device).manual_seed(
            seed if seed is not None else 0)
        scale = torch.tensor(cfg_scale, dtype=torch.float32, device=self.device)
        for i, t in enumerate(timesteps):
            sigma, next_sigma = sigmas[i], sigmas[i + 1]
            latent_in = torch.cat([latents] * 2) if do_cfg else latents
            latent_in = self.scheduler.scale_model_input(latent_in, sigma)
            t_batch = torch.full((latent_in.shape[0],), float(t),
                                 dtype=torch.float32, device=self.device)
            noise_pred = self.denoiser(latent_in, t_batch, ehs, pooled, osz, tsz, crop,
                                       cross_attention_kwargs)
            if do_cfg:
                pos_pred, neg_pred = noise_pred.float().chunk(2)
                noise_pred = neg_pred + scale * (pos_pred - neg_pred)
            noise = None if step_noise is None else torch.as_tensor(step_noise[i])
            latents = self.scheduler.ancestral_step(
                latents, noise_pred, sigma, next_sigma, generator=generator,
                noise=noise).to(execution_dtype)
        if return_latents:
            return latents
        return self.decode_image(latents, use_tiling=should_tile)
