"""SDXL checkpoint keys and layouts (the port's own copy of the rules in
``vision_pt_tpu/models/sdxl/convert.py``).

Three layers of names:

1. the sgm/original single-file keys (``model.diffusion_model.input_blocks
   .N...``, ``first_stage_model...``, ``conditioner.embedders...``) <-> the
   reference's internal torch keys (``denoiser.input_blocks.blocks.N...``),
   plus the comfy export keys;
2. the internal torch keys <-> the port's ``state_dict`` keys: the port's
   modules carry the JAX package's attribute names (``time_embed.linear_1``
   for ``time_embed.0``, ``ff.geglu.proj`` for ``ff.net.0.proj`` ...) in
   torch's tensor layout, so only names change;
3. the JAX package's parameters (``flatten_state``, as numpy) -> the port's
   ``state_dict`` (:func:`from_jax_state`): transposes and renamed leaves.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# ------------------------------------------------- sgm <-> internal keys


def unet_block_convert_from_original_key(key: str) -> str:
    key = re.sub(r"(input|output)_blocks\.", r"\1_blocks.blocks.", key)
    return key.replace("middle_block.", "middle_block.blocks.", 1)


def unet_block_convert_to_original_key(key: str) -> str:
    key = re.sub(r"(input|output)_blocks\.blocks\.", r"\1_blocks.", key)
    return key.replace("middle_block.blocks.", "middle_block.", 1)


def vae_convert_from_original_key(key: str, num_blocks: int = 4) -> str:
    if ".mid." in key:
        key = re.sub(r"block_(\d+)", lambda m: f"resnets.{int(m.group(1)) - 1}", key)
    key = key.replace(".attn_1.", ".attentions.0.", 1)
    key = key.replace(".q.", ".to_q.", 1)
    key = key.replace(".k.", ".to_k.", 1)
    key = key.replace(".v.", ".to_v.", 1)
    if ".attn" in key or ".attentions." in key:
        key = key.replace(".proj_out.", ".to_out.0.", 1)
    key = key.replace(".norm.", ".group_norm.", 1)
    key = key.replace(".nin_shortcut.", ".conv_shortcut.", 1)
    key = key.replace(".mid.", ".mid_block.", 1)
    if groups := re.search(r".*\.up\.(\d+)\..*", key):
        key = re.sub(r"\.up\.\d+\.",
                     f".up_blocks.{num_blocks - 1 - int(groups.group(1))}.", key)
    elif groups := re.search(r".*\.down\.(\d+)\..*", key):
        key = re.sub(r"\.down\.\d+\.", f".down_blocks.{int(groups.group(1))}.", key)
    key = key.replace(".upsample.conv.", ".upsamplers.0.conv.", 1)
    key = key.replace(".downsample.conv.", ".downsamplers.0.conv.", 1)
    key = key.replace(".block.", ".resnets.", 1)
    return key.replace(".norm_out.", ".conv_norm_out.", 1)


def vae_convert_to_original_key(key: str, num_blocks: int = 4) -> str:
    if ".mid_block." in key:
        key = re.sub(r"resnets\.(\d+)", lambda m: f"block_{int(m.group(1)) + 1}", key)
    key = key.replace(".attentions.0.", ".attn_1.", 1)
    key = key.replace(".to_q.", ".q.", 1)
    key = key.replace(".to_k.", ".k.", 1)
    key = key.replace(".to_v.", ".v.", 1)
    key = key.replace(".to_out.0.", ".proj_out.", 1)
    key = key.replace(".group_norm.", ".norm.", 1)
    key = key.replace(".conv_shortcut.", ".nin_shortcut.", 1)
    key = key.replace(".mid_block.", ".mid.", 1)
    if groups := re.search(r".*\.up_blocks\.(\d+)\..*", key):
        key = re.sub(r"\.up_blocks\.\d+\.",
                     f".up.{num_blocks - 1 - int(groups.group(1))}.", key)
    elif groups := re.search(r".*\.down_blocks\.(\d+)\..*", key):
        key = re.sub(r"\.down_blocks\.\d+\.", f".down.{int(groups.group(1))}.", key)
    key = key.replace(".upsamplers.0.conv.", ".upsample.conv.", 1)
    key = key.replace(".downsamplers.0.conv.", ".downsample.conv.", 1)
    key = key.replace(".resnets.", ".block.", 1)
    return key.replace(".conv_norm_out.", ".norm_out.", 1)


def root_convert_from_original_key(key: str) -> str:
    key = key.replace("model.diffusion_model.", "diffusion_model.", 1)
    key = key.replace("diffusion_model.", "denoiser.", 1)
    key = key.replace("conditioner.embedders.0.transformer.",
                      "text_encoder.text_encoder_1.", 1)
    key = key.replace("conditioner.embedders.1.model.text_projection",
                      "text_encoder.text_encoder_2.text_projection.weight", 1)
    key = key.replace("conditioner.embedders.1.model.",
                      "text_encoder.text_encoder_2.text_model.", 1)
    return key.replace("first_stage_model.", "vae.", 1)


def root_convert_to_original_key(key: str) -> str:
    key = key.replace("denoiser.", "model.diffusion_model.", 1)
    key = key.replace("text_encoder.text_encoder_1.",
                      "conditioner.embedders.0.transformer.", 1)
    key = key.replace("text_encoder.text_encoder_2.text_projection.weight",
                      "conditioner.embedders.1.model.text_projection", 1)
    key = key.replace("text_encoder.text_encoder_2.text_model.",
                      "conditioner.embedders.1.model.", 1)
    return key.replace("vae.", "first_stage_model.", 1)


def convert_from_original_key(key: str) -> str:
    key = root_convert_from_original_key(key)
    if key.startswith("denoiser."):
        key = unet_block_convert_from_original_key(key)
    elif key.startswith("vae."):
        key = vae_convert_from_original_key(key)
    return key


def convert_to_original_key(key: str) -> str:
    if key.startswith("denoiser."):
        key = unet_block_convert_to_original_key(key)
    elif key.startswith("vae."):
        key = vae_convert_to_original_key(key)
    return root_convert_to_original_key(key)


def convert_to_comfy_key(key: str) -> str:
    key = key.replace("text_encoder.text_encoder_1.", "clip_l.", 1)
    key = key.replace("text_encoder.text_encoder_2.", "clip_g.", 1)
    if key.startswith("denoiser."):
        key = unet_block_convert_to_original_key(key)
        key = key.replace("denoiser.", "diffusion_model.", 1)
    return key


def convert_from_comfy_key(key: str) -> str:
    """The inverse of :func:`convert_to_comfy_key`: an exported LoRA key back
    to its module path in the training tree."""
    key = key.replace("clip_l.", "text_encoder.text_encoder_1.", 1)
    key = key.replace("clip_g.", "text_encoder.text_encoder_2.", 1)
    if key.startswith("diffusion_model."):
        key = key.replace("diffusion_model.", "denoiser.", 1)
        key = unet_block_convert_from_original_key(key)
    return key


# ------------------------------------------------- internal torch <-> port

# the reference's sequential indices and container names -> the port's
# attribute names (ordered, literal, first occurrence)
_RENAMES = [
    ("time_embed.0.", "time_embed.linear_1."),
    ("time_embed.2.", "time_embed.linear_2."),
    ("label_emb.0.0.", "label_emb.linear_1."),
    ("label_emb.0.2.", "label_emb.linear_2."),
    (".in_layers.0.", ".in_norm."),
    (".in_layers.2.", ".in_conv."),
    (".emb_layers.1.", ".emb_linear."),
    (".out_layers.0.", ".out_norm."),
    (".out_layers.3.", ".out_conv."),
    (".to_out.0.", ".to_out."),
    (".ff.net.0.proj.", ".ff.geglu.proj."),
    (".ff.net.2.", ".ff.out."),
    (".downsamplers.0.conv.", ".downsampler."),  # diffusers VAE
    (".upsamplers.0.conv.", ".upsampler."),
    (".encoder.layers.", ".layers."),  # CLIP text model
]
_RENAMES_TOP = [("out.0.", "out_norm."), ("out.2.", "out_conv.")]


def torch_to_port_key(key: str) -> str:
    for old, new in _RENAMES:
        if old in key:
            key = key.replace(old, new, 1)
    for old, new in _RENAMES_TOP:
        if key.startswith(old):
            key = new + key[len(old):]
    return key


def port_to_torch_key(key: str) -> str:
    for old, new in _RENAMES:
        if new in key:
            key = key.replace(new, old, 1)
    for old, new in _RENAMES_TOP:
        if key.startswith(new):
            key = old + key[len(new):]
    return key


def fix_vae_attention_projections(sd: dict) -> dict:
    """Original-format VAEs store the attention projections as 4-D 1x1
    convs; flatten them to 2-D."""
    for key in list(sd):
        if re.search(r".*\.to_(q|k|v|out)\.(\d+\.)?weight$", key):
            value = np.asarray(sd[key])
            if value.ndim == 4:
                sd[key] = value[:, :, 0, 0]
    return sd


_LORA_LEAVES = {"lora_down": "lora_down.weight", "lora_up": "lora_up.weight",
                "lora_up_bias": "lora_up.bias"}


def from_jax_state(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The JAX package's parameters (``flatten_state`` keys, as numpy) -> the
    port's ``state_dict``: a linear ``kernel`` (in, out) becomes ``weight``
    (out, in), a conv ``kernel`` HWIO becomes ``weight`` OIHW, a norm
    ``scale`` and an embedding table become ``weight``, and a LoRA factor
    (``lora_down`` (in, rank), ``lora_up`` (rank, out)) its kohya-layout
    ``weight``."""
    out: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        value = np.asarray(value)
        base, dot, leaf = key.rpartition(".")
        if leaf == "kernel":
            value = value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1)
            key = f"{base}{dot}weight"
        elif leaf in ("scale", "embedding"):
            key = f"{base}{dot}weight"
        elif leaf in _LORA_LEAVES:
            value = value.T if value.ndim == 2 else value
            key = f"{base}{dot}{_LORA_LEAVES[leaf]}"
        out[key] = torch.from_numpy(np.array(value))
    return out
