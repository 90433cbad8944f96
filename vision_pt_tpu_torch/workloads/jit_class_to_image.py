"""JiT class-to-image rectified-flow training workload (port of
``vision_pt_tpu/workloads/jit_class_to_image.py``).

Host side: class tokenisation and the CFG context drop (the drop RNG is
``np.random.default_rng(seed + 1)``, as in the JAX package, so the same
batches drop). Device side: ``scale_shift_sigmoid`` timesteps and noise
(``draw_randoms``), the scaled-noise interpolation with t = 1 clean, the
denoiser, and an x-prediction loss in velocity space (``_treat_loss``).
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image
from torch import nn

from ..models.jit import JiTConfig, JiTModel
from ..ops.loss.flow_match import prepare_scaled_noised_latents
from ..ops.timestep.sampling import TimestepSamplingType, sample_timestep
from ..training.model import ModelForTraining


class JiTConfigForTraining(JiTConfig):
    checkpoint_path: str | None = None
    max_token_length: int = 64
    noise_scale: float = 1.0
    timestep_eps: float = 0.05
    loss_target: str = "velocity"  # "velocity" | "image"
    timestep_sampling: TimestepSamplingType = "scale_shift_sigmoid"
    train_class_encoder: bool = True
    drop_context_rate: float = 0.1

    @property
    def is_from_scratch(self) -> bool:
        return self.checkpoint_path is None


class JiTTrainable(nn.Module):
    """The trainable modules: the denoiser and the class encoder."""

    def __init__(self, denoiser: nn.Module, class_encoder: nn.Module):
        super().__init__()
        self.denoiser = denoiser
        self.class_encoder = class_encoder


class JiTForClassToImageTraining(ModelForTraining):
    model: JiTModel
    model_class: type[JiTModel] = JiTModel
    model_config: JiTConfigForTraining
    model_config_class = JiTConfigForTraining
    mesh_draws = ("timesteps", "noise")

    def setup_model(self):
        cfg = self.model_config
        if cfg.is_from_scratch:
            self.model = self.model_class.new_with_config(
                cfg, seed=self.config.seed, device=self.device
            )
        else:
            self.model = self.model_class.from_pretrained(
                cfg, cfg.checkpoint_path, device=self.device
            )
        self._trainable = JiTTrainable(self.model.denoiser, self.model.class_encoder)
        self._drop_rng = np.random.default_rng(self.config.seed + 1)

    def get_host_rng_state(self) -> dict:
        return {"drop_rng": self._drop_rng.bit_generator.state}

    def set_host_rng_state(self, state: dict) -> None:
        self._drop_rng.bit_generator.state = state["drop_rng"]

    def enable_gradient_checkpointing(self):
        self.model.denoiser.set_gradient_checkpointing(True)

    def trainable(self) -> nn.Module:
        return self._trainable

    @torch.no_grad()
    def sanity_check(self):
        """One forward on a zero probe. Unlike the JAX package's check (a
        3-channel 64^2 image, which fails for other channel counts), the probe
        takes the denoiser's ``in_channels`` and a side that is a multiple of
        ``patch_size``."""
        denoiser_cfg = self.model.config.denoiser
        patch, batch = denoiser_cfg.patch_size, 2
        size = patch * -(-64 // patch)
        noise = torch.zeros(batch, size, size, denoiser_cfg.in_channels,
                            device=self.device)
        prompt = torch.zeros(batch, self.model_config.max_token_length,
                             self.model.config.denoiser.context_dim,
                             device=self.device)
        t = torch.full((batch,), 0.5, device=self.device)
        sizes = torch.full((batch, 2), float(size), device=self.device)
        self.model.denoiser(noise, t, prompt, sizes, sizes, torch.zeros_like(sizes))

    # ------------------------------------------------------------ batch

    def prepare_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        captions: list[str] = batch["caption"]
        drop_context = self._drop_rng.random() < self.model_config.drop_context_rate
        if drop_context:
            captions = [""] * len(captions)
        ids, mask = self.model.class_encoder.tokenizer.tokenize(
            captions, max_length=self.model_config.max_token_length
        )
        if drop_context:
            mask = np.ones_like(mask)  # a dropped context attends every token
        image = batch["latents"] if "latents" in batch else batch["image"]
        if image.ndim == 4 and image.shape[-1] != 3 and image.shape[1] == 3:
            image = np.moveaxis(image, 1, -1)  # tolerate NCHW input
        return {
            "image": torch.as_tensor(np.ascontiguousarray(image)).to(self.device),
            "class_ids": torch.from_numpy(ids).long().to(self.device),
            "context_mask": torch.from_numpy(mask).to(self.device),
        }

    def draw_randoms(self, batch: dict, generator: torch.Generator) -> dict:
        """The timesteps and the standard-normal noise of one step."""
        images = batch["image"]
        timesteps = sample_timestep(
            generator, images.shape[0], self.model_config.timestep_sampling,
            device=images.device,
        )
        noise = torch.randn(images.shape, generator=generator,
                            device=images.device, dtype=images.dtype)
        return {"timesteps": timesteps, "noise": noise}

    # ------------------------------------------------------------ loss

    def _treat_loss(self, model_pred, noisy, clean, noise, timesteps):
        cfg = self.model_config
        t = timesteps.reshape(-1, 1, 1, 1)
        pred32, clean32, noisy32 = model_pred.float(), clean.float(), noisy.float()
        if cfg.model_pred == "image":
            if cfg.loss_target == "velocity":
                denom = torch.clamp_min(1.0 - t, cfg.timestep_eps)
                target_v = (clean32 - noisy32) / denom
                pred_v = (pred32 - noisy32) / denom
                return torch.mean(torch.square(pred_v - target_v))
            if cfg.loss_target == "image":
                return torch.mean(torch.square(pred32 - clean32))
            raise ValueError(f"Unknown loss target: {cfg.loss_target}")
        if cfg.model_pred == "velocity":
            if cfg.loss_target == "velocity":
                target_v = clean32 - noise.float()
                return torch.mean(torch.square(pred32 - target_v))
            raise NotImplementedError(
                "Velocity prediction with image loss is not implemented."
            )
        raise NotImplementedError(f"model_pred={cfg.model_pred}")

    def _step_inputs(self, trainable: JiTTrainable, batch: dict, draws: dict):
        """The class context, timesteps, noised images, noise and square
        size conditioning of one step (the variants share them)."""
        cfg = self.model_config
        images = batch["image"]
        context = trainable.class_encoder(batch["class_ids"])
        if not cfg.train_class_encoder:
            context = context.detach()
        timesteps = draws["timesteps"]
        noisy, noise = prepare_scaled_noised_latents(
            None, images, timesteps, noise_scale=cfg.noise_scale,
            draw=draws["noise"],
        )
        size = torch.tensor([[images.shape[1], images.shape[2]]],
                            dtype=torch.float32, device=images.device)
        return context, timesteps, noisy, noise, size.repeat(images.shape[0], 1)

    def compute_loss(self, trainable: JiTTrainable, batch: dict, draws: dict):
        images = batch["image"]
        context, timesteps, noisy, noise, size = self._step_inputs(
            trainable, batch, draws)
        model_pred = trainable.denoiser(
            noisy, timesteps, context, size, size, torch.zeros_like(size),
            context_mask=batch["context_mask"],
        )
        l2_loss = self._treat_loss(model_pred, noisy, images, noise, timesteps)
        metrics = {"l2_loss": l2_loss.detach()}
        # the packed kernel's no-max softmax is exact while this bound stays
        # <= BOUNDED_LOGIT_CLIP (60)
        bound = trainable.denoiser.qk_logit_bound()
        if bound is not None:
            metrics["qk_logit_bound"] = bound
        return l2_loss, metrics

    # ------------------------------------------------------------ preview

    def preview_step(self, preview_args, preview_index: int) -> list[Image.Image]:
        return self.model.generate(
            prompt=preview_args.prompt,
            negative_prompt=preview_args.negative_prompt,
            width=preview_args.width,
            height=preview_args.height,
            num_inference_steps=preview_args.num_steps,
            cfg_scale=preview_args.cfg_scale,
            max_token_length=self.model_config.max_token_length,
            seed=preview_args.seed,
        )
