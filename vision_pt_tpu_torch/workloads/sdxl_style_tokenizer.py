"""SDXL style tokenizer training (port of
``vision_pt_tpu/workloads/sdxl_style_tokenizer.py``).

The two projectors train (AdapterParams) while the UNet, both text
encoders, the VAE and the vision tower stay frozen. Gradients flow THROUGH
the frozen text encoders into the style rows, so the text encode runs with
autograd on, unlike the other SDXL workloads. Encoder 1 sees the expanded
placeholder, encoder 2 the caption as written (the JAX package's asymmetry).
A batch's image-drop draws come from ``np.random.default_rng(seed + 13)``,
as in the JAX package; the step's other draws from ``draw_randoms``.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch
from PIL import Image
from torch import nn

from ..models.sdxl.adapter.style_tokenizer import (
    SDXLModelWithStyleTokenizer,
    SDXLModelWithStyleTokenizerConfig,
)
from ..models.sdxl.text_encoder import CHUNK_LENGTH, _merge_chunks
from ..ops.long_prompt import tokenize_long_prompt
from ..ops.loss.diffusion import loss_with_predicted_noise, prepare_noised_latents
from ..parallel.mesh import gather_rows
from ..peft import freeze_all_but_adapters
from .sdxl_ip_adapter import drop_image, resize_images
from .sdxl_prompt_free import SDXLPFGSelfTraining
from .sdxl_text_to_image import SDXLForTextToImageTraining, SDXLForTextToImageTrainingConfig


class SDXLModelWithStyleTokenizerTrainingConfig(SDXLForTextToImageTrainingConfig,
                                                SDXLModelWithStyleTokenizerConfig):
    max_token_length: int = 225
    drop_image_rate: float = 0.1
    freeze_vision_encoder: bool = True
    freeze_projector: bool = False
    timestep_sampling: Literal["uniform", "gaussian"] = "uniform"
    timestep_sampling_args: dict = {}


class StyleTokenizerTrainable(nn.Module):
    def __init__(self, denoiser, projector_1, projector_2, text_encoder_1, text_encoder_2,
                 vae):
        super().__init__()
        self.denoiser = denoiser
        self.projector_1 = projector_1
        self.projector_2 = projector_2
        self.text_encoder = nn.ModuleDict(dict(text_encoder_1=text_encoder_1,
                                               text_encoder_2=text_encoder_2))
        self.vae = vae


class SDXLStyleTokenizerTraining(SDXLForTextToImageTraining):
    model: SDXLModelWithStyleTokenizer
    model_config: SDXLModelWithStyleTokenizerTrainingConfig
    model_config_class = SDXLModelWithStyleTokenizerTrainingConfig
    pipeline_class = SDXLModelWithStyleTokenizer

    # uniform or gaussian integers, as ``timestep_sampling`` says
    sample_timesteps = SDXLPFGSelfTraining.sample_timesteps

    def setup_model(self):
        cfg = self.model_config
        if not cfg.freeze_vision_encoder:
            raise NotImplementedError(
                "training the vision tower needs local pretrained weights; only "
                "freeze_vision_encoder=True is supported")
        super().setup_model()  # a checkpoint's load adds the style token
        if not cfg.checkpoint_path:
            self.model.setup_style_token()
        if not cfg.freeze_projector:
            self.model.manager.set_adapter_trainable(True)
        self._full_trainable = StyleTokenizerTrainable(
            self.model.denoiser, self.model.projector_1, self.model.projector_2,
            self.model.text_encoder.text_encoder_1, self.model.text_encoder.text_encoder_2,
            self.model.vae)
        freeze_all_but_adapters(self._full_trainable)
        self._is_peft = True
        self._drop_rng = np.random.default_rng(self.config.seed + 13)

    def trainable(self) -> nn.Module:
        return self._full_trainable

    def prepare_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        captions: list[str] = batch["caption"]
        te = self.model.text_encoder
        max_len = self.model_config.max_token_length
        out = {}
        # encoder 1 sees the expanded placeholder, encoder 2 does not
        for i, tokenizer, token_id, texts in (
                (1, te.tokenizer_1, te.style_token_id_1,
                 te.preprocess_style_token(list(captions))),
                (2, te.tokenizer_2, te.style_token_id_2, list(captions))):
            ids, _ = tokenize_long_prompt(tokenizer, texts, max_length=max_len,
                                          chunk_length=CHUNK_LENGTH)
            ids = torch.as_tensor(ids).long().to(self.device)
            out[f"ids{i}"] = ids
            # each row's first style row: the placeholders in the rows before
            # it (a mesh rank's block starts at its first row's)
            per_row = (ids == token_id).sum(dim=1)
            out[f"style_offset_{i}"] = torch.cumsum(per_row, 0) - per_row
        image = batch["image"]
        if image.ndim == 4 and image.shape[-1] != 3 and image.shape[1] == 3:
            image = np.moveaxis(image, 1, -1)
        out["image"] = torch.as_tensor(np.ascontiguousarray(image)).to(self.device)
        ref = batch.get("reference_image")
        source = out["image"] if ref is None else torch.as_tensor(np.asarray(ref)).to(
            self.device)
        if source.shape[1] == 3 and source.shape[-1] != 3:
            source = source.permute(0, 2, 3, 1)
        resized = resize_images(source, self.model_config.adapter.image_size)
        out["reference_pixels"] = self.model.preprocess_reference_image(resized)
        out["drop_image"] = drop_image(self._drop_rng, self.model_config.drop_image_rate,
                                       out["image"].shape[0], self.device)
        for name in ("original_size", "target_size", "crop_coords_top_left"):
            out[name] = torch.as_tensor(np.asarray(batch[name], np.float32)).to(self.device)
        return out

    def compute_loss(self, trainable: StyleTokenizerTrainable, batch: dict, draws: dict):
        images = batch["image"]
        batch_size = images.shape[0]
        te = self.model.text_encoder
        vae = self.model.vae
        with torch.no_grad():
            features = self.model.vision_encoder(batch["reference_pixels"])
            latents = vae.encode(images).sample(noise=draws["vae_noise"]) * vae.scaling_factor
        drop = batch["drop_image"][:, None, None]
        style_1 = torch.where(drop, 0.0, trainable.projector_1(features).style_tokens)
        style_2 = torch.where(drop, 0.0, trainable.projector_2(features).style_tokens)
        if self.mesh is not None:
            # the placeholders take rows in flat order over the whole batch:
            # every rank's style rows, their gradients back to their rank
            style_1, style_2 = (gather_rows(s, self.mesh) for s in (style_1, style_2))
        # the text encode WITH gradients into the style rows
        out1 = trainable.text_encoder["text_encoder_1"](
            batch["ids1"], style_embeddings=style_1, style_token_id=te.style_token_id_1,
            style_offset=batch["style_offset_1"][0])
        out2 = trainable.text_encoder["text_encoder_2"](
            batch["ids2"], style_embeddings=style_2, style_token_id=te.style_token_id_2,
            style_offset=batch["style_offset_2"][0])
        emb1 = _merge_chunks(out1.penultimate_hidden_state, batch_size)
        emb2 = _merge_chunks(out2.penultimate_hidden_state, batch_size)
        # encoder 1's expanded prompt may chunk longer: align on the shorter
        seq = min(emb1.shape[1], emb2.shape[1])
        ehs = torch.cat([emb1[:, :seq], emb2[:, :seq]], dim=-1)
        pooled = out2.text_embeds.reshape(batch_size, -1, out2.text_embeds.shape[-1])[:, 0]
        timesteps = draws["timesteps"]
        noisy, noise = prepare_noised_latents(None, latents, timesteps, draw=draws["noise"])
        noise_pred = trainable.denoiser(noisy, timesteps.float(), ehs, pooled,
                                        batch["original_size"], batch["target_size"],
                                        batch["crop_coords_top_left"])
        l2_loss = loss_with_predicted_noise(latents, noise, noise_pred)
        return l2_loss, {"l2_loss": l2_loss.detach()}

    # ------------------------------------------------------------ save

    def get_state_dict_to_save(self) -> dict[str, torch.Tensor]:
        return self.model.adapter_state_dict()

    def preview_step(self, preview_args, preview_index: int) -> list[Image.Image]:
        reference_image = None
        if path := (preview_args.extra or {}).get("reference_image_path"):
            reference_image = Image.open(path).convert("RGB")
        return self.model.generate(
            prompt=preview_args.prompt, negative_prompt=preview_args.negative_prompt or "",
            reference_image=reference_image, width=preview_args.width,
            height=preview_args.height, num_inference_steps=preview_args.num_steps,
            cfg_scale=preview_args.cfg_scale, seed=preview_args.seed,
            max_token_length=self.model_config.max_token_length)
