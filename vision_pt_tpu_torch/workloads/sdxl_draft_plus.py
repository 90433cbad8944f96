"""SDXL DRaFT+ reward fine-tuning (port of
``vision_pt_tpu/workloads/sdxl_draft_plus.py``).

Each step samples ``total_steps`` Euler-ancestral CFG steps from noise and
backpropagates only through the last ``truncation_steps`` (DRaFT): the early
steps run under ``torch.no_grad()``, where eager autograd would otherwise
keep every UNet call's activations. The differentiated tail decodes the
latents with the VAE WITH a gradient, scores the pixels with the reward
models (frozen towers, gradients through them to the pixels) and adds the
DRaFT+ regularizer, ||draft_pred - ref_pred||^2 against the same UNet with
its adapters off (no gradient). It needs PEFT: the reference model is the
adapters disabled. The step's draws (the initial latents, unscaled, and
each step's ancestral noise) come from ``draw_randoms``, so a test can hand
in others.
"""

from __future__ import annotations

import torch
from PIL import Image

from ..models.sdxl.text_encoder import CHUNK_LENGTH, _merge_chunks
from ..ops.long_prompt import tokenize_long_prompt
from ..parallel.mesh import batch_rows, shard_batch
from ..peft.functional import while_peft_disabled
from ..reward import load_reward_models
from .sdxl_text_to_image import (
    SDXLForTextToImageTraining,
    SDXLForTextToImageTrainingConfig,
    SDXLTrainable,
)


class SDXLForDRaFTPlusTrainingConfig(SDXLForTextToImageTrainingConfig):
    truncation_steps: int = 1
    total_steps: int = 25
    cfg_scale: float = 5.0
    sample_height: int = 1024
    sample_width: int = 1024
    reward_models: list[dict] = [{"type": "brightness"}]
    draft_reg_weight: float = 1.0


class SDXLDRaFTPlusTraining(SDXLForTextToImageTraining):
    mesh_draws = ("latents", "step_noise")
    model_config: SDXLForDRaFTPlusTrainingConfig
    model_config_class = SDXLForDRaFTPlusTrainingConfig

    def setup_model(self):
        super().setup_model()
        self.reward_models = load_reward_models(self.model_config.reward_models,
                                                device=self.device)

    # ------------------------------------------------------------ batch

    def prepare_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        """The captions and their negatives, tokenised [positive; negative];
        the sample's size as the conditioning of every row."""
        cfg = self.model_config
        captions: list[str] = batch["caption"]
        negatives: list[str] = batch.get("negative_prompt", [""] * len(captions))
        te = self.model.text_encoder
        all_prompts = list(captions) + list(negatives)
        out = {}
        for name, tokenizer in (("ids1", te.tokenizer_1), ("ids2", te.tokenizer_2)):
            ids, _ = tokenize_long_prompt(tokenizer, all_prompts,
                                          max_length=cfg.max_token_length,
                                          chunk_length=CHUNK_LENGTH)
            out[name] = torch.as_tensor(ids).long().to(self.device)
        self._current_prompts = list(captions)  # for the reward models
        size = torch.tensor([[float(cfg.sample_height), float(cfg.sample_width)]],
                            device=self.device).expand(2 * len(captions), 2)
        out.update(original_size=size, target_size=size,
                   crop_coords_top_left=torch.zeros_like(size),
                   cfg_scale=torch.tensor(float(batch.get("cfg_scale", cfg.cfg_scale)),
                                          device=self.device))
        return out

    def shard_rows(self, batch: dict, mesh) -> dict:
        """This rank's prompts under ``trainer.mesh``: the block of the
        positive rows and the same block of the negative rows (a block of
        [positive; negative] would part them), and their captions for the
        reward models."""
        index, count = batch_rows(mesh)
        rows = len(self._current_prompts) // count
        self._current_prompts = self._current_prompts[index * rows:(index + 1) * rows]
        return {k: torch.cat([shard_batch(half, mesh) for half in v.chunk(2)])
                if v.dim() > 0 else v for k, v in batch.items()}

    def draw_randoms(self, batch: dict, generator: torch.Generator) -> dict:
        """The initial latents (standard normal, before the largest sigma
        scales them) and each sampler step's ancestral noise."""
        cfg = self.model_config
        ratio = self.model.vae.compression_ratio
        shape = (batch["original_size"].shape[0] // 2, cfg.sample_height // ratio,
                 cfg.sample_width // ratio, cfg.denoiser.in_channels)
        latents = torch.randn(shape, generator=generator, device=self.device)
        # one a sampler step: leading spacing gives total_steps steps, or one
        # more where 1000 is not a multiple of it
        steps = len(self.model.prepare_timesteps(cfg.total_steps)[0])
        step_noise = [torch.randn(shape, generator=generator, device=self.device)
                      for _ in range(steps)]
        return {"latents": latents, "step_noise": step_noise}

    # ------------------------------------------------------------ loss

    def _encode_all(self, trainable, ids1, ids2, n_all: int):
        if isinstance(trainable, SDXLTrainable):
            te1 = trainable.text_encoder["text_encoder_1"]
            te2 = trainable.text_encoder["text_encoder_2"]
        else:
            te1 = self.model.text_encoder.text_encoder_1
            te2 = self.model.text_encoder.text_encoder_2
        out1, out2 = te1(ids1), te2(ids2)
        ehs = torch.cat([_merge_chunks(out1.penultimate_hidden_state, n_all),
                         _merge_chunks(out2.penultimate_hidden_state, n_all)], dim=-1)
        pooled = out2.text_embeds.reshape(n_all, -1, out2.text_embeds.shape[-1])[:, 0]
        return ehs, pooled

    def compute_loss(self, trainable, batch: dict, draws: dict):
        cfg = self.model_config
        denoiser = trainable.denoiser if isinstance(trainable, SDXLTrainable) else trainable
        n_all = batch["original_size"].shape[0]  # 2 * batch size (positive + negative)
        with torch.no_grad():
            ehs, pooled = self._encode_all(trainable, batch["ids1"], batch["ids2"], n_all)
        cond = (ehs, pooled, batch["original_size"], batch["target_size"],
                batch["crop_coords_top_left"])

        scheduler = self.model.scheduler
        timesteps, sigmas = self.model.prepare_timesteps(cfg.total_steps)
        latents = draws["latents"] * scheduler.get_max_noise_sigma(sigmas)
        cfg_scale = batch["cfg_scale"]
        no_grad_steps = cfg.total_steps - cfg.truncation_steps

        def guided(latent_in, t_batch):
            pos, neg = denoiser(latent_in, t_batch, *cond).float().chunk(2)
            return neg + cfg_scale * (pos - neg)  # fp32, as the JAX promotion

        draft_preds, ref_preds = [], []
        for i, t in enumerate(timesteps):
            sigma, next_sigma = sigmas[i], sigmas[i + 1]
            latent_in = scheduler.scale_model_input(torch.cat([latents] * 2), sigma)
            t_batch = torch.full((latent_in.shape[0],), float(t), device=self.device)
            tail = i >= no_grad_steps
            with torch.set_grad_enabled(tail and torch.is_grad_enabled()):
                noise_pred = guided(latent_in, t_batch)
                latents = scheduler.ancestral_step(latents, noise_pred, sigma, next_sigma,
                                                   noise=draws["step_noise"][i])
            if not tail:
                continue
            draft_preds.append(noise_pred)
            with torch.no_grad(), while_peft_disabled(denoiser):
                ref_preds.append(guided(latent_in, t_batch))

        # decode WITH gradients: the reward sees pixels
        images = self.model.vae.decode(latents / self.model.vae.scaling_factor)
        rewards = torch.stack([rm(images, self._current_prompts).float()
                               for rm in self.reward_models])  # (num_rewards, B)
        reward = rewards.mean()
        reward_loss = -reward
        draft = torch.stack(draft_preds, dim=1).float()
        ref = torch.stack(ref_preds, dim=1).float()
        reg_loss = torch.mean(torch.square(draft - ref))
        total = reward_loss + cfg.draft_reg_weight * reg_loss
        return total, {"reward": reward.detach(), "reward_loss": reward_loss.detach(),
                       "draft_reg_loss": reg_loss.detach()}

    def preview_step(self, preview_args, preview_index: int) -> list[Image.Image]:
        return self.model.generate(
            prompt=preview_args.prompt, negative_prompt=preview_args.negative_prompt or "",
            width=preview_args.width, height=preview_args.height,
            num_inference_steps=preview_args.num_steps, cfg_scale=preview_args.cfg_scale,
            seed=preview_args.seed, max_token_length=self.model_config.max_token_length)
