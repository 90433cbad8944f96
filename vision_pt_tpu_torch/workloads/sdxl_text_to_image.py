"""SDXL DDPM epsilon-prediction fine-tuning, LoRA / QLoRA / full (port of
``vision_pt_tpu/workloads/sdxl_text_to_image.py``).

The host tokenises long prompts in chunks; the step runs both text encoders
and the VAE encoder without gradients, draws uniform integer timesteps,
noises the latents with the DDPM schedule and takes the eps-MSE of the UNet.
The step's draws (the VAE sample's noise, the timesteps, the latent noise)
come from ``draw_randoms``, so a test can hand in others.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image
from torch import nn

from ..models.sdxl import SDXLConfig, SDXLModel
from ..models.sdxl.convert import convert_from_comfy_key, convert_to_comfy_key
from ..models.sdxl.text_encoder import CHUNK_LENGTH, _merge_chunks, load_tokenizers
from ..ops.long_prompt import tokenize_long_prompt
from ..ops.loss.diffusion import loss_with_predicted_noise, prepare_noised_latents
from ..ops.timestep.sampling import uniform_randint
from ..peft import get_adapter_parameters
from ..training.model import ModelForTraining


class SDXLForTextToImageTrainingConfig(SDXLConfig):
    # null: random weights from the run's seed
    checkpoint_path: str | None = None
    max_token_length: int = 225  # 75 * 3
    # a directory with the CLIP tokenizers (tokenizer/, tokenizer_2/), or
    # "word-hash"; the JAX package's model carries none
    tokenizer: str | None = None


class SDXLTrainable(nn.Module):
    """The training tree, rooted as the reference's SDXLModel, so the PEFT
    keys (``attn1``, excluding ``text_encoder`` and ``vae``) match."""

    def __init__(self, denoiser, text_encoder_1, text_encoder_2, vae):
        super().__init__()
        self.denoiser = denoiser
        self.text_encoder = nn.ModuleDict(dict(text_encoder_1=text_encoder_1,
                                               text_encoder_2=text_encoder_2))
        self.vae = vae


class SDXLForTextToImageTraining(ModelForTraining):
    model: SDXLModel
    model_config: SDXLForTextToImageTrainingConfig
    model_config_class = SDXLForTextToImageTrainingConfig
    pipeline_class = SDXLModel
    # under trainer.mesh: data and fsdp only (the tensor rules would split
    # GeGLU's fused halves, the LoRA branches and the text towers: ROADMAP
    # Queue 1 item 5); vae_noise only when the step encodes the images
    mesh_draws = ("vae_noise", "timesteps", "noise")
    mesh_axes = ("data", "fsdp")

    def setup_model(self):
        cfg = self.model_config
        if cfg.tokenizer is None:
            raise ValueError("model.tokenizer must name the CLIP tokenizers' "
                             "directory, or word-hash")
        tokenizer_1, tokenizer_2 = load_tokenizers(cfg.tokenizer)
        self.model = self.pipeline_class.from_config(
            cfg, seed=self.config.seed, device=self.device,
            tokenizer_1=tokenizer_1, tokenizer_2=tokenizer_2)
        if cfg.checkpoint_path:
            self.model._load_checkpoint(cfg.checkpoint_path)
        self._full_trainable = SDXLTrainable(
            self.model.denoiser, self.model.text_encoder.text_encoder_1,
            self.model.text_encoder.text_encoder_2, self.model.vae)

    def trainable(self) -> nn.Module:
        """The whole tree under PEFT (for the keys; only the adapters
        train), the UNet alone otherwise."""
        if self._is_peft or self.config.peft is not None:
            return self._full_trainable
        return self._full_trainable.denoiser

    def enable_gradient_checkpointing(self):
        self.model.denoiser.set_gradient_checkpointing(True)

    @torch.no_grad()
    def sanity_check(self):
        denoiser_cfg = self.model_config.denoiser
        zeros = dict(device=self.device)
        lat = torch.zeros(1, 12, 12, denoiser_cfg.in_channels, **zeros)
        ehs = torch.zeros(1, 77, denoiser_cfg.context_dim, **zeros)
        pooled = torch.zeros(1, 1280, **zeros)
        t = torch.tensor([50.0], **zeros)
        size = torch.full((1, 2), 96.0, **zeros)
        self.model.denoiser(lat, t, ehs, pooled, size, size, torch.zeros_like(size))

    # ------------------------------------------------------------ batch

    def prepare_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        """Every tensor with the batch's rows on its leading axis (a mesh
        splits them there): the token ids (batch, chunks, 77), the size and
        crop conditions, the images or the cached latents."""
        captions: list[str] = batch["caption"]
        max_len = self.model_config.max_token_length
        te = self.model.text_encoder
        out = {}
        for name, tokenizer in (("ids1", te.tokenizer_1), ("ids2", te.tokenizer_2)):
            ids, _ = tokenize_long_prompt(tokenizer, captions, max_length=max_len,
                                          chunk_length=CHUNK_LENGTH)
            out[name] = torch.as_tensor(ids).long().reshape(
                len(captions), -1, ids.shape[-1]).to(self.device)
        for name in ("original_size", "target_size", "crop_coords_top_left"):
            out[name] = torch.as_tensor(np.asarray(batch[name], np.float32)).to(self.device)
        if "latents" in batch:
            # cached VAE latents: already sampled and scaled
            out["latents"] = torch.as_tensor(np.asarray(batch["latents"])).to(self.device)
        else:
            image = batch["image"]
            if image.ndim == 4 and image.shape[-1] != 3 and image.shape[1] == 3:
                image = np.moveaxis(image, 1, -1)  # tolerate NCHW input
            out["image"] = torch.as_tensor(np.ascontiguousarray(image)).to(self.device)
        return out

    def draw_randoms(self, batch: dict, generator: torch.Generator) -> dict:
        """The VAE sample's noise (not with cached latents), uniform integer
        timesteps in [0, 1000) and the latent noise, standard normal."""
        if "latents" in batch:
            shape = tuple(batch["latents"].shape)
        else:
            b, h, w, _ = batch["image"].shape
            ratio = self.model.vae.compression_ratio
            shape = (b, h // ratio, w // ratio, self.model.vae.latent_channels)
        device = self.device
        draws = {}
        if "latents" not in batch:
            draws["vae_noise"] = torch.randn(shape, generator=generator, device=device)
        draws["timesteps"] = self.sample_timesteps(generator, shape[0])
        draws["noise"] = torch.randn(shape, generator=generator, device=device)
        return draws

    def sample_timesteps(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        return uniform_randint(generator, batch_size, 0, 1000, device=self.device)

    # the image-drop generator of the adapter workloads, for train states
    def get_host_rng_state(self) -> dict:
        rng = getattr(self, "_drop_rng", None)
        return {} if rng is None else {"drop_rng": rng.bit_generator.state}

    def set_host_rng_state(self, state: dict) -> None:
        if "drop_rng" in state:
            self._drop_rng.bit_generator.state = state["drop_rng"]

    # ------------------------------------------------------------ loss

    def _encode_text(self, trainable, ids1, ids2, batch_size: int):
        if isinstance(trainable, SDXLTrainable):
            te1 = trainable.text_encoder["text_encoder_1"]
            te2 = trainable.text_encoder["text_encoder_2"]
        else:  # UNet-only training: the pipeline's frozen encoders
            te1 = self.model.text_encoder.text_encoder_1
            te2 = self.model.text_encoder.text_encoder_2
        # (batch, chunks, 77) -> the chunks as rows of their own
        out1 = te1(ids1.reshape(-1, ids1.shape[-1]))
        out2 = te2(ids2.reshape(-1, ids2.shape[-1]))
        ehs = torch.cat([_merge_chunks(out1.penultimate_hidden_state, batch_size),
                         _merge_chunks(out2.penultimate_hidden_state, batch_size)],
                        dim=-1)
        pooled = out2.text_embeds.reshape(batch_size, -1,
                                          out2.text_embeds.shape[-1])[:, 0]
        return ehs, pooled

    def compute_loss(self, trainable: nn.Module, batch: dict, draws: dict):
        batch_size = (batch["latents"] if "latents" in batch else batch["image"]).shape[0]
        denoiser = trainable.denoiser if isinstance(trainable, SDXLTrainable) else trainable
        vae = self.model.vae
        with torch.no_grad():
            ehs, pooled = self._encode_text(trainable, batch["ids1"], batch["ids2"],
                                            batch_size)
            if "latents" in batch:
                latents = batch["latents"]
            else:
                dist = vae.encode(batch["image"])
                latents = dist.sample(noise=draws["vae_noise"]) * vae.scaling_factor
        timesteps = draws["timesteps"]
        noisy, noise = prepare_noised_latents(None, latents, timesteps,
                                              draw=draws["noise"])
        noise_pred = denoiser(noisy, timesteps.float(), ehs, pooled,
                              batch["original_size"], batch["target_size"],
                              batch["crop_coords_top_left"])
        l2_loss = loss_with_predicted_noise(latents, noise, noise_pred)
        return l2_loss, {"l2_loss": l2_loss.detach()}

    # ------------------------------------------------------------ save/preview

    def get_state_dict_to_save(self) -> dict[str, torch.Tensor]:
        """The adapters under the comfy/kohya keys under PEFT, else the
        whole model in the sgm layout."""
        if not self._is_peft:
            return self.model.state_dict()
        adapters = get_adapter_parameters(self._full_trainable)
        return {convert_to_comfy_key(k): v for k, v in adapters.items()}

    def peft_keys_to_paths(self, state_dict: dict) -> dict:
        return {convert_from_comfy_key(k): v for k, v in state_dict.items()}

    def preview_step(self, preview_args, preview_index: int) -> list[Image.Image]:
        negative = preview_args.negative_prompt
        if negative is None and preview_args.cfg_scale > 0:
            negative = ""
        return self.model.generate(
            prompt=preview_args.prompt, negative_prompt=negative,
            width=preview_args.width, height=preview_args.height,
            num_inference_steps=preview_args.num_steps,
            cfg_scale=preview_args.cfg_scale, seed=preview_args.seed,
            max_token_length=self.model_config.max_token_length,
        )
