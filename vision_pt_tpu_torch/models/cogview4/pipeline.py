"""CogView4 pipeline (port of ``vision_pt_tpu/models/cogview4/pipeline.py``):
checkpoint IO, the linear time-shift schedule with a resolution-dependent
mu, the CFG Euler loop and the VAE decode. Inference only, as in the JAX
package: there is no CogView4 trainer.

Everything runs on ``device``: the CUDA device unless the caller asks for
another. The model is built there from a generator seeded with ``seed``, so
the 16 B parameters of the full-width random model never touch the host.

Divergences from the JAX package, each kept on purpose:

- ``state_dict`` writes the original ``to_out.0.`` key; the JAX package
  writes ``to_out.0.0.`` (its generic renamer adds the ``.0`` its CogView4
  renamer adds again). Both packages load either.
- ``param_dtype`` reaches the GLM tower too; the JAX package always builds
  it with fp32 parameters.

As in the JAX package, a checkpoint loads the DiT and the VAE; the GLM
tower keeps the weights it was built with.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image
from torch import nn

from ...ops.quant.functional import load_state_with_prequantized
from ...ops.timestep.sampling import time_shift_linear
from ...utils import PromptType, resolve_device
from ...utils import tensor as tensor_utils
from ..sdxl.convert import port_to_torch_key, torch_to_port_key
from ..sdxl.vae import VAE
from .config import CogView4Config
from .denoiser import Denoiser
from .text_encoder import DEFAULT_MAX_TOKEN_LENGTH, TextEncoder, glm_config


def calculate_time_shift(image_seq_len, base_seq_len: int = 256,
                         base_shift: float = 0.25, max_shift: float = 0.75) -> float:
    """The resolution-dependent mu."""
    m = (image_seq_len / base_seq_len) ** 0.5
    return m * max_shift + base_shift


def convert_from_original_key(key: str) -> str:
    key = key.replace("diffusion_model.", "denoiser.", 1)
    return key.replace("text_encoder.", "text_encoder.model.", 1)


def convert_to_original_key(key: str) -> str:
    key = key.replace("denoiser.", "diffusion_model.", 1)
    return key.replace("text_encoder.model.", "text_encoder.", 1)


# the diffusers sequential names of the DiT's feed-forward and output
# projection -> the module's attribute names
_DENOISER_RENAMES = ((".ff.net.0.proj.", ".ff.proj."), (".ff.net.2.", ".ff.out."),
                     (".to_out.0.", ".to_out."))

# CogView4 ships a 16-channel SDXL-style KL VAE
COGVIEW4_VAE_CONFIG = dict(
    block_out_channels=(128, 512, 1024, 1024),
    latent_channels=16,
    layers_per_block=3,
    scaling_factor=1.0,
)


class CogView4Model:
    """The DiT, the VAE and the GLM-4 text encoder, on one device."""

    denoiser_class: type[Denoiser] = Denoiser

    def __init__(self, config: CogView4Config, *, dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype = torch.float32, seed: int = 0,
                 device: str | torch.device | None = None, tokenizer=None,
                 build_text_encoder: bool = True):
        self.config = config
        self.device = resolve_device(device)
        if dtype is None and config.torch_dtype != torch.float32:
            dtype = config.torch_dtype
        self._dtype = dtype
        generator = torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        with self.device:
            self.denoiser = self.denoiser_class(config.denoiser, **kw).eval()
            self.vae = VAE(**(config.vae_config or COGVIEW4_VAE_CONFIG), **kw).eval()
            # the GLM tower is optional at construction: inference tools
            # often work from precomputed embeddings
            self.text_encoder = TextEncoder.from_default(
                tokenizer, config=glm_config(config.text_encoder_config), **kw,
            ) if build_text_encoder else None

    @classmethod
    def from_config(cls, config: CogView4Config, **kw) -> "CogView4Model":
        """Random weights drawn from ``seed`` on ``device``."""
        return cls(config, **kw)

    def to(self, device: str | torch.device) -> "CogView4Model":
        """Move every module to ``device`` (in place)."""
        self.device = torch.device(device)
        for module in self.modules().values():
            module.to(self.device)
        return self

    def modules(self) -> dict[str, nn.Module]:
        """The model's modules by state prefix, the text encoder's LM
        included (checkpoints hold only the DiT and the VAE)."""
        out = {"denoiser.": self.denoiser, "vae.": self.vae}
        if self.text_encoder is not None:
            out["text_encoder.model."] = self.text_encoder.model
        return out

    # ---------------------------------------------------------- checkpoint

    def _load_checkpoint(self, checkpoint_path: str, strict: bool = True):
        """Load a single-file checkpoint in the original layout, plain or
        with linears prequantized in the bnb layout."""
        from safetensors.torch import load_file

        sd = {convert_from_original_key(k): v
              for k, v in load_file(checkpoint_path).items()}
        denoiser = {}
        for key, value in sd.items():
            if key.startswith("denoiser."):
                key = key[len("denoiser."):]
                for old, name in _DENOISER_RENAMES:
                    key = key.replace(old, name)
                denoiser[torch_to_port_key(key)] = value
        load_state_with_prequantized(self.denoiser, denoiser, strict=strict)
        vae = {torch_to_port_key(k[len("vae."):]): v for k, v in sd.items()
               if k.startswith("vae.")}
        if vae:
            load_state_with_prequantized(self.vae, vae, strict=strict)

    @classmethod
    def from_checkpoint(cls, config: CogView4Config, **kw) -> "CogView4Model":
        """Random init on the device, then the checkpoint at
        ``config.checkpoint_path`` loaded over it."""
        model = cls.from_config(config, **kw)
        model._load_checkpoint(config.checkpoint_path)
        return model

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The DiT and the VAE in the original key layout, on the host.
        Quantized layers keep only their biases, as in the JAX package."""
        out: dict[str, torch.Tensor] = {}
        for prefix, module in (("denoiser.", self.denoiser), ("vae.", self.vae)):
            for k, v in module.named_parameters():
                k = port_to_torch_key(k).replace(".ff.proj.", ".ff.net.0.proj.")
                out[convert_to_original_key(prefix + k)] = v.detach().cpu().clone()
        return out

    # ---------------------------------------------------------- sampling

    def prepare_latents(self, batch_size: int, height: int, width: int,
                        dtype: torch.dtype, seed: int | None = None,
                        latents: torch.Tensor | np.ndarray | None = None):
        """Per-sample seeded noise (NHWC), or ``latents`` as given."""
        if latents is not None:
            return torch.as_tensor(latents).to(self.device, dtype)
        shape = (batch_size, int(height) // self.vae.compression_ratio,
                 int(width) // self.vae.compression_ratio,
                 self.config.denoiser.in_channels)
        return tensor_utils.incremental_seed_randn(shape, seed=seed, dtype=dtype,
                                                   device=self.device)

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> NHWC images in [-1, 1]; no shift factor, as in the JAX
        package (the scaling factor is 1.0)."""
        with torch.inference_mode():
            return self.vae.decode(latents / self.vae.scaling_factor)

    def decode_image(self, latents: torch.Tensor) -> list[Image.Image]:
        return tensor_utils.tensor_to_images(self.decode_latents(latents))

    def prepare_timesteps(self, num_inference_steps: int, height: int, width: int):
        """Integer timesteps 1000 -> 1 and the sigmas, linearly time-shifted
        by a resolution-dependent mu, with a trailing 0."""
        image_seq_len = ((height // self.vae.compression_ratio)
                         * (width // self.vae.compression_ratio)
                         // (self.denoiser.patch_size**2))
        timesteps = np.linspace(1000.0, 1.0, num_inference_steps).astype(
            np.int64).astype(np.float32)
        mu = calculate_time_shift(image_seq_len)
        sigmas = time_shift_linear(mu, torch.from_numpy(timesteps / 1000.0)).numpy()
        return timesteps, np.concatenate([sigmas, [0.0]]).astype(np.float32)

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
        seed: int | None = None,
        max_token_length: int = DEFAULT_MAX_TOKEN_LENGTH,
        execution_dtype: torch.dtype = torch.bfloat16,
        do_offloading: bool = False,  # accepted and unread, as in the JAX package
        return_latents: bool = False,
        latents: torch.Tensor | np.ndarray | None = None,  # initial, NHWC
    ) -> list[Image.Image] | torch.Tensor:
        """Euler sampling of the velocity with CFG ``v_neg + cfg (v_pos -
        v_neg)``; each step's latents are rounded back to their dtype."""
        do_cfg = cfg_scale > 1.0
        timesteps, sigmas = self.prepare_timesteps(num_inference_steps, height, width)
        batch_size = len(prompt) if isinstance(prompt, list) else 1
        original_size = original_size or (height, width)
        target_size = target_size or (height, width)

        encoder_output = self.text_encoder.encode_prompts(
            prompt, negative_prompt, use_negative_prompts=do_cfg,
            max_token_length=max_token_length)
        latents = self.prepare_latents(batch_size, height, width, execution_dtype,
                                       seed=seed, latents=latents)
        ehs = encoder_output.positive_embeddings
        if do_cfg:
            ehs = torch.cat([ehs, encoder_output.negative_embeddings])
        ehs = ehs.to(execution_dtype)
        n = ehs.shape[0]

        def rows(pair):
            return torch.tensor(pair, dtype=torch.float32,
                                device=self.device).expand(n, 2)

        osz, tsz, crop = rows(original_size), rows(target_size), rows(crop_coords_top_left)
        for i, t in enumerate(timesteps):
            latent_in = torch.cat([latents] * 2) if do_cfg else latents
            t_batch = torch.full((n,), float(t), dtype=torch.float32, device=self.device)
            velocity = self.denoiser(latent_in, ehs, t_batch, osz, tsz, crop)
            if do_cfg:
                v_pos, v_neg = velocity.chunk(2)
                velocity = v_neg + cfg_scale * (v_pos - v_neg)
            dt = float(sigmas[i + 1] - sigmas[i])
            latents = latents + velocity.to(latents.dtype) * dt
        if return_latents:
            return latents
        return self.decode_image(latents)
