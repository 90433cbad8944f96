"""JiT pipeline: construction, checkpoint IO and Euler rectified-flow
sampling (port of ``vision_pt_tpu/models/jit/pipeline.py``).

CFG batch doubling, renorm, dynamic thresholding and the CFG time-range gate
follow the JAX package, including where its dtypes promote. Images are NHWC
in [-1, 1]. Everything runs on ``device``: the CUDA device unless the caller
asks for another.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from ...utils import PromptType, resolve_device
from ...utils import tensor as tensor_utils
from .class_encoder import ClassEncoder
from .config import ClassContextConfig, JiTConfig
from .convert import port_to_reference, reference_to_port
from .denoiser import Denoiser


class JiTModel:
    """The denoiser and its class encoder, on one device. The variants of
    ``extension/`` set ``denoiser_class``."""

    denoiser_class: type[torch.nn.Module] = Denoiser

    def __init__(self, config: JiTConfig, *, dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        self.config = config
        self.device = resolve_device(device)
        if dtype is None:
            dtype = config.torch_dtype if config.torch_dtype != torch.float32 else None
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if not isinstance(config.context_encoder, ClassContextConfig):
            raise NotImplementedError(
                "text context encoder is not ported yet: ROADMAP Queue 1 "
                "item 6 (models/jit/text_encoder.py)"
            )
        self.denoiser = self.denoiser_class(
            config.denoiser, dtype=dtype, param_dtype=param_dtype,
            generator=generator, device=self.device,
        ).eval()
        self.class_encoder = ClassEncoder(
            label2id=config.context_encoder.label2id,
            embedding_dim=config.denoiser.context_dim,
            splitter=config.context_encoder.splitter,
            do_mask_padding=config.context_encoder.do_mask_padding,
            param_dtype=param_dtype, generator=generator,
        ).to(self.device).eval()

    # ---------------------------------------------------------- checkpoint

    def _submodules(self) -> dict[str, torch.nn.Module]:
        return {"denoiser": self.denoiser, "class_encoder": self.class_encoder}

    def _rope_head_dim(self) -> int | None:
        """Head dim of the RoPE deinterleave permutation (``convert.py``);
        None for PoPE, whose q/k channels keep the reference's order."""
        cfg = self.config.denoiser
        if cfg.positional_encoding != "rope":
            return None
        return cfg.hidden_size // cfg.num_heads

    def state_dict(self) -> dict[str, torch.Tensor]:
        """Reference-layout flat state dict with submodel prefixes (the
        on-disk format the JAX package and the reference share)."""
        flat = {
            f"{prefix}.{key}": value
            for prefix, mod in self._submodules().items()
            for key, value in mod.state_dict().items()
        }
        cfg = self.config.denoiser
        return port_to_reference(flat, cfg.patch_size, cfg.in_channels,
                                 rope_head_dim=self._rope_head_dim())

    def save_checkpoint(self, path: str, metadata: dict[str, str] | None = None):
        from safetensors.torch import save_file

        save_file(self.state_dict(), path, metadata=metadata)

    def _load_checkpoint(self, checkpoint_path: str, strict: bool = True):
        from safetensors.numpy import load_file

        sd = reference_to_port(load_file(checkpoint_path),
                               rope_head_dim=self._rope_head_dim())
        for prefix, mod in self._submodules().items():
            sub = {k[len(prefix) + 1:]: v for k, v in sd.items()
                   if k.startswith(prefix + ".")}
            mod.load_state_dict(sub, strict=strict)

    @classmethod
    def from_pretrained(cls, config: JiTConfig, checkpoint_path: str,
                        **kwargs) -> "JiTModel":
        model = cls(config, **kwargs)
        model._load_checkpoint(checkpoint_path)
        return model

    @classmethod
    def new_with_config(cls, config: JiTConfig, seed: int = 0,
                        device: str | torch.device | None = None,
                        **kwargs) -> "JiTModel":
        return cls(config, generator=torch.Generator().manual_seed(seed),
                   device=device, **kwargs)

    # ---------------------------------------------------------- sampling

    def prepare_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """0 -> 1 linspace with num_steps + 1 entries (noise at t=0)."""
        return np.linspace(0.0, 1.0, num_inference_steps + 1, dtype=np.float32)

    def prepare_noisy_image(self, batch_size: int, height: int, width: int,
                            dtype: torch.dtype = torch.float32,
                            seed: int | None = None) -> torch.Tensor:
        return tensor_utils.incremental_seed_randn(
            (batch_size, height, width, 3), seed=seed, dtype=dtype,
            device=self.device,
        )

    def normalize_prompts(self, prompt: PromptType) -> list[str]:
        return prompt if isinstance(prompt, list) else [prompt]

    def prepare_context_embeddings(self, prompts: PromptType,
                                   negative_prompt: PromptType,
                                   max_token_length: int = 64,
                                   do_cfg: bool = False):
        """Positive (+ negative under CFG) class embeddings and masks,
        batch-concatenated."""
        emb, mask = self.class_encoder.encode_prompts(
            prompts, max_token_length=max_token_length
        )
        if do_cfg:
            neg_emb, neg_mask = self.class_encoder.encode_prompts(
                negative_prompt, max_token_length=max_token_length
            )
            emb = torch.cat([emb, neg_emb], dim=0)
            mask = torch.cat([mask, neg_mask], dim=0)
        return emb, mask

    def prepare_image_size_inputs(self, width: int, height: int,
                                  batch_size: int,
                                  dtype: torch.dtype = torch.float32):
        original = torch.tensor([[height, width]], dtype=dtype,
                                device=self.device).repeat(batch_size, 1)
        crop = torch.zeros(batch_size, 2, dtype=dtype, device=self.device)
        return original, original, crop

    # -- velocity conversions --------------------------------------------

    def image_to_velocity(self, image, noisy, timestep, clamp_eps: float = 1e-5):
        t = timestep.reshape(-1, 1, 1, 1)
        return (image - noisy) / torch.clamp_min(1.0 - t, clamp_eps)

    def renorm_cfg(self, positive_velocity, cfg_velocity):
        # norm over axis 2 of NHWC (the reference's last NCHW axis, width)
        pos_norm = torch.linalg.vector_norm(positive_velocity, dim=2, keepdim=True)
        cfg_norm = torch.linalg.vector_norm(cfg_velocity, dim=2, keepdim=True)
        return cfg_velocity * (pos_norm / torch.clamp_min(cfg_norm, 1e-12))

    def dynamic_thresholding(self, images, percentile: float = 0.995):
        batch = images.shape[0]
        flat = images.reshape(batch, -1).abs()
        # linear interpolation between order statistics, as jnp.quantile
        s = torch.quantile(flat.float(), percentile, dim=1, keepdim=True)
        s = torch.clamp_min(s.to(images.dtype), 1.0).reshape(batch, 1, 1, 1)
        return torch.clamp(images, -s, s) / s

    def make_velocity_pred(self, model_pred, noisy_image, timestep):
        batch = noisy_image.shape[0]
        if self.config.model_pred == "image":
            return self.image_to_velocity(
                model_pred[:batch], noisy_image, timestep.expand(batch)
            ).to(model_pred.dtype)
        if self.config.model_pred == "velocity":
            return model_pred[:batch]
        raise NotImplementedError(f"model_pred={self.config.model_pred}")

    def make_cfg_velocity_pred(self, model_pred, noisy_image, timestep,
                               cfg_scale, do_cfg_renorm: bool = False,
                               do_dynamic_thresholding: bool = False):
        """``timestep`` is a 0-d fp32 tensor. ``cfg_scale`` is a Python float
        (the JAX per-step loop: the guidance stays in the prediction dtype)
        or a 0-d fp32 tensor (the JAX scanned loop, where a strongly typed
        fp32 scale promotes the guidance to fp32)."""
        batch = noisy_image.shape[0]
        t_b = timestep.expand(batch)
        if self.config.model_pred == "image":
            img_pos, img_neg = model_pred.chunk(2, dim=0)
            v_pos = self.image_to_velocity(img_pos, noisy_image, t_b).to(model_pred.dtype)
            v_neg = self.image_to_velocity(img_neg, noisy_image, t_b).to(model_pred.dtype)
        elif self.config.model_pred == "velocity":
            v_pos, v_neg = model_pred.chunk(2, dim=0)
        else:
            raise NotImplementedError(f"model_pred={self.config.model_pred}")

        if isinstance(cfg_scale, torch.Tensor):
            dt = torch.promote_types(v_pos.dtype, cfg_scale.dtype)
            velocity = v_pos.to(dt) + cfg_scale * (v_pos.to(dt) - v_neg.to(dt))
        else:
            velocity = v_pos + cfg_scale * (v_pos - v_neg)
        if do_cfg_renorm:
            velocity = self.renorm_cfg(v_pos, velocity)
        if do_dynamic_thresholding:
            # the fp32 timestep promotes the predicted image to fp32
            image_pred = noisy_image.float() + velocity.float() * (1.0 - timestep)
            image_pred = self.dynamic_thresholding(image_pred)
            velocity = self.image_to_velocity(image_pred, noisy_image, t_b)
        return velocity

    def _denoise(self, image, t, context, mask, original_size, target_size,
                 crop_coords):
        n = image.shape[0]
        return self.denoiser(
            image=image,
            timestep=torch.full((n,), float(t), dtype=torch.float32, device=image.device),
            context=context[:n], original_size=original_size[:n],
            target_size=target_size[:n], crop_coords=crop_coords[:n],
            context_mask=mask[:n],
        )

    def _scan_sample(self, noisy_image, timesteps, context, mask,
                     original_size, target_size, crop_coords, cfg_scale, *,
                     use_cfg: bool, do_cfg_renorm: bool,
                     do_dynamic_thresholding: bool):
        """The Euler loop with CFG the same at every step (the JAX package's
        scanned loop): fp32 scale, timestep and step size, and the carried
        image kept in its own dtype."""
        x = noisy_image
        scale = torch.tensor(cfg_scale, dtype=torch.float32, device=x.device)
        ts = torch.from_numpy(timesteps).to(x.device)
        for i in range(len(timesteps) - 1):
            t, dt = ts[i], ts[i + 1] - ts[i]
            inp = torch.cat([x, x]) if use_cfg else x
            pred = self._denoise(inp, timesteps[i], context, mask,
                                 original_size, target_size, crop_coords)
            if use_cfg:
                v = self.make_cfg_velocity_pred(
                    pred, x, t, cfg_scale=scale, do_cfg_renorm=do_cfg_renorm,
                    do_dynamic_thresholding=do_dynamic_thresholding,
                )
            else:
                v = self.make_velocity_pred(pred, x, t)
            x = x + v.to(x.dtype) * dt.to(x.dtype)
        return x

    # ---------------------------------------------------------- generate

    @torch.inference_mode()
    def generate(
        self,
        prompt: PromptType,
        negative_prompt: PromptType | None = None,
        width: int = 256,
        height: int = 256,
        num_inference_steps: int = 20,
        cfg_scale: float = 2.0,
        max_token_length: int = 64,
        seed: int | None = None,
        execution_dtype: torch.dtype = torch.bfloat16,
        do_cfg_renorm: bool = False,
        do_dynamic_thresholding: bool = False,
        cfg_time_range: tuple[float, float] = (0.0, 1.0),
        initial_noise: torch.Tensor | np.ndarray | None = None,  # NHWC
        return_arrays: bool = False,
    ) -> list[Image.Image] | torch.Tensor:
        """Euler rectified-flow sampling from noise at t=0 to the image at
        t=1; returns PIL images, or the NHWC tensor with ``return_arrays``."""
        do_cfg = cfg_scale > 1.0
        timesteps = self.prepare_timesteps(num_inference_steps)
        prompts = self.normalize_prompts(prompt)
        batch_size = len(prompts)

        if initial_noise is not None:
            noisy_image = torch.as_tensor(initial_noise).to(
                device=self.device, dtype=execution_dtype
            )
        else:
            noisy_image = self.prepare_noisy_image(
                batch_size, height, width, dtype=execution_dtype, seed=seed
            )

        negative_prompts = self.normalize_prompts(
            negative_prompt if negative_prompt is not None else [""]
        )
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

        step_uses_cfg = [
            do_cfg and cfg_time_range[0] <= float(t) <= cfg_time_range[1]
            for t in timesteps[:-1]
        ]
        if len(set(step_uses_cfg)) == 1:
            noisy_image = self._scan_sample(
                noisy_image, timesteps, prompt_embeddings, attention_mask,
                original_size, target_size, crop_coords, cfg_scale,
                use_cfg=step_uses_cfg[0], do_cfg_renorm=do_cfg_renorm,
                do_dynamic_thresholding=do_dynamic_thresholding,
            )
        else:
            for i, t in enumerate(timesteps[:-1]):
                use_cfg = step_uses_cfg[i]
                image_input = torch.cat([noisy_image] * 2) if use_cfg else noisy_image
                model_pred = self._denoise(
                    image_input, t, prompt_embeddings, attention_mask,
                    original_size, target_size, crop_coords,
                )
                t_arr = torch.tensor(t, dtype=torch.float32, device=self.device)
                if use_cfg:
                    velocity = self.make_cfg_velocity_pred(
                        model_pred, noisy_image, t_arr, cfg_scale=cfg_scale,
                        do_cfg_renorm=do_cfg_renorm,
                        do_dynamic_thresholding=do_dynamic_thresholding,
                    )
                else:
                    velocity = self.make_velocity_pred(model_pred, noisy_image, t_arr)
                # a Python step size is weakly typed in JAX: it is rounded to
                # the image dtype before the multiply
                dt = torch.tensor(float(timesteps[i + 1] - t),
                                  dtype=noisy_image.dtype, device=self.device)
                noisy_image = noisy_image + velocity.to(noisy_image.dtype) * dt

        if return_arrays:
            return noisy_image
        return tensor_utils.tensor_to_images(noisy_image)
