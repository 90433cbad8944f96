"""State-dict key utilities (the port's own copy of the part of
``vision_pt_tpu/utils/state_dict.py`` that the SDXL path uses). A
``torch.nn.Module``'s ``state_dict()`` and ``load_state_dict`` take the place
of the JAX package's ``flatten_state`` and ``load_flat_state``."""

from __future__ import annotations

import re

import numpy as np


def get_target_keys(
    keys: list[str],
    include_patterns: list[str],
    exclude_patterns: list[str] | None = None,
) -> list[str]:
    """Include/exclude key matching: a pattern matches a key it is a
    substring of, or a regex that searches it."""

    def matches(key: str, pattern: str) -> bool:
        if pattern in key:
            return True
        try:
            return re.search(pattern, key) is not None
        except re.error:
            return False

    out = []
    for key in keys:
        if not any(matches(key, p) for p in include_patterns):
            continue
        if exclude_patterns and any(matches(key, p) for p in exclude_patterns):
            continue
        out.append(key)
    return out


# ----------------------------------------------------- open_clip converters


def _convert_key_open_clip_to_transformers(key: str) -> str:
    key = key.replace("positional_embedding", "embeddings.position_embedding.weight", 1)
    key = key.replace("token_embedding", "embeddings.token_embedding", 1)
    key = key.replace("transformer.resblocks", "encoder.layers", 1)
    key = key.replace(".attn.", ".self_attn.", 1)
    key = key.replace(".ln_1.", ".layer_norm1.", 1)
    key = key.replace(".ln_2.", ".layer_norm2.", 1)
    key = key.replace(".mlp.c_fc.", ".mlp.fc1.", 1)
    key = key.replace(".mlp.c_proj.", ".mlp.fc2.", 1)
    key = key.replace("ln_final", "final_layer_norm", 1)
    return key


def _convert_key_transformers_to_open_clip(key: str) -> str:
    key = key.replace("embeddings.position_embedding.weight", "positional_embedding", 1)
    key = key.replace("embeddings.token_embedding", "token_embedding", 1)
    key = key.replace("encoder.layers", "transformer.resblocks", 1)
    key = key.replace(".self_attn.", ".attn.", 1)
    key = key.replace(".layer_norm1.", ".ln_1.", 1)
    key = key.replace(".layer_norm2.", ".ln_2.", 1)
    key = key.replace(".mlp.fc1.", ".mlp.c_fc.", 1)
    key = key.replace(".mlp.fc2.", ".mlp.c_proj.", 1)
    key = key.replace("final_layer_norm", "ln_final", 1)
    return key


def convert_open_clip_to_transformers(state_dict: dict) -> dict[str, np.ndarray]:
    """open_clip layout -> HF transformers layout, including the fused
    in_proj qkv split."""
    new_sd: dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        if "logit_scale" in key:
            continue
        new_sd[_convert_key_open_clip_to_transformers(key)] = np.asarray(value)
    for key in list(new_sd.keys()):
        if re.match(r".*\.in_proj_(weight|bias)$", key):
            kind = "weight" if key.endswith("weight") else "bias"
            for name, part in zip("qkv", np.split(new_sd.pop(key), 3, axis=0)):
                new_sd[key.replace(f"in_proj_{kind}", f"{name}_proj.{kind}")] = part
    return new_sd


def convert_transformers_to_open_clip(state_dict: dict) -> dict[str, np.ndarray]:
    new_sd: dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        if m := re.search(r"(.*)\.(q|k|v)_proj\.(weight|bias)$", key):
            base, which, kind = m.group(1), m.group(2), m.group(3)
            if which != "q":
                continue  # handled once per triple
            fused = np.concatenate(
                [np.asarray(state_dict[f"{base}.{n}_proj.{kind}"]) for n in "qkv"],
                axis=0,
            )
            new_sd[_convert_key_transformers_to_open_clip(
                f"{base}.in_proj_{kind}")] = fused
        else:
            new_sd[_convert_key_transformers_to_open_clip(key)] = np.asarray(value)
    return new_sd
