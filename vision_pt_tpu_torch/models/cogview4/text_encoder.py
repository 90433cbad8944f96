"""GLM-4 text conditioning encoder for CogView4 (port of
``vision_pt_tpu/models/cogview4/text_encoder.py``).

The port's ``models/lm`` decoder with the GLM-4-9B config; the conditioning
is its penultimate hidden state (the state entering the last layer), the
prompts padded to the longest and then left-padded to a multiple of 16 with
the pad id. The attention masks are all ones: the LM attends to the left
pads, as in the JAX package.

:class:`TextEncoder` is a plain object holding the LM, not a module, as in
the JAX package: a walk of the model's modules (``quantize_inplace``) does
not reach it. Tokenizers are pluggable: an HF tokenizer from a local
directory, or :class:`GLMWordHashTokenizer`, which needs no vocabulary file.
Nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import NamedTuple

import numpy as np
import torch

from ...utils import PromptType
from ..lm.model import DecoderLM, DecoderLMConfig

DEFAULT_MAX_TOKEN_LENGTH = 1024
DEFAULT_TOKENIZER_REPO = "THUDM/CogView4-6B"
PAD_TOKEN_ID = 151329

# the GLM-4-9B text tower
GLM4_CONFIG = DecoderLMConfig(
    vocab_size=151552,
    hidden_size=4096,
    intermediate_size=13696,
    num_hidden_layers=40,
    num_attention_heads=32,
    num_key_value_heads=2,
    head_dim=128,
    rms_norm_eps=1.5625e-07,
    rope_theta=10000.0,
    partial_rotary_factor=0.5,
    attention_bias=True,
    hidden_act="silu",
    arch="glm",
)


class GLMWordHashTokenizer:
    """HF-like tokenizer without a vocabulary file: each word maps to a
    stable hash in [0, 151329); with special tokens the row starts with
    GLM-4's ``[gMASK]<sop>`` (151331, 151333). Rows are padded on the left
    with 151329, as GLM-4's tokenizer pads."""

    pad_token_id = PAD_TOKEN_ID
    prefix_ids = (151331, 151333)

    def __call__(self, texts, max_length=DEFAULT_MAX_TOKEN_LENGTH,
                 padding="longest", truncation=True, add_special_tokens=True):
        rows = []
        for text in texts:
            ids = list(self.prefix_ids) if add_special_tokens else []
            ids += [zlib.crc32(w.encode()) % PAD_TOKEN_ID for w in text.split()]
            rows.append(ids[:max_length] if truncation else ids)
        width = max(map(len, rows)) if padding == "longest" else max_length
        ids = [[PAD_TOKEN_ID] * (width - len(r)) + r for r in rows]
        return {"input_ids": np.asarray(ids, dtype=np.int64)}


def load_tokenizer(spec: str):
    """The GLM tokenizer from a local directory (HF layout), or the
    word-hash stand-in for ``"word-hash"``."""
    if spec == "word-hash":
        return GLMWordHashTokenizer()
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(spec, local_files_only=True)


def glm_config(overrides: dict | None = None) -> DecoderLMConfig:
    """GLM4_CONFIG with some fields replaced (e.g. the depth)."""
    return dataclasses.replace(GLM4_CONFIG, **(overrides or {}))


class TextEncodingOutput(NamedTuple):
    positive_embeddings: torch.Tensor
    positive_attention_mask: torch.Tensor
    negative_embeddings: torch.Tensor
    negative_attention_mask: torch.Tensor


class TextEncoder:
    def __init__(self, model: DecoderLM, tokenizer,
                 pad_token_id: int = PAD_TOKEN_ID):
        self.model = model
        self.tokenizer = tokenizer
        self.pad_token_id = getattr(tokenizer, "pad_token_id", None) or pad_token_id

    @classmethod
    def from_default(cls, tokenizer=None, *, config: DecoderLMConfig = GLM4_CONFIG,
                     dtype=None, param_dtype=torch.float32,
                     generator: torch.Generator | None = None) -> "TextEncoder":
        """The GLM-4 tower (random weights from ``generator``) on the current
        default device."""
        model = DecoderLM(config, dtype=dtype, param_dtype=param_dtype,
                          generator=generator).eval()
        return cls(model, tokenizer)

    def normalize_prompts(self, prompts, negative_prompts=None,
                          use_negative_prompts=True):
        _p = prompts if isinstance(prompts, list) else [prompts]
        if not use_negative_prompts:
            return _p, []
        if negative_prompts is None:
            return _p, [""] * len(_p)
        _n = negative_prompts if isinstance(negative_prompts, list) else [negative_prompts]
        if len(_n) == 1 and len(_p) > 1:
            _n = _n * len(_p)
        return _p, _n

    def tokenize(self, texts: list[str], max_token_length: int) -> np.ndarray:
        """Token ids padded to the longest row, then left-padded to a
        multiple of 16."""
        enc = self.tokenizer(texts, max_length=max_token_length, padding="longest",
                             truncation=True, add_special_tokens=True)
        input_ids = np.asarray(enc["input_ids"] if isinstance(enc, dict)
                               else enc.input_ids)
        pad = (-input_ids.shape[1]) % 16
        if pad:
            input_ids = np.concatenate(
                [np.full((input_ids.shape[0], pad), self.pad_token_id,
                         dtype=input_ids.dtype), input_ids], axis=1)
        return input_ids

    @torch.inference_mode()
    def encode_prompts(
        self,
        prompts: PromptType,
        negative_prompts: PromptType | None = None,
        use_negative_prompts: bool = False,
        max_token_length: int = DEFAULT_MAX_TOKEN_LENGTH,
    ) -> TextEncodingOutput:
        if self.tokenizer is None:
            raise RuntimeError(
                "CogView4 text encoding needs a GLM tokenizer with local files "
                f"(repo: {DEFAULT_TOKENIZER_REPO}); nothing is downloaded. Pass "
                "one (or GLMWordHashTokenizer()) as the model's tokenizer.")
        _p, _n = self.normalize_prompts(prompts, negative_prompts,
                                        use_negative_prompts)
        input_ids = self.tokenize(_p + _n, max_token_length)
        device = self.model.embed_tokens.weight.device
        hidden = self.model(torch.from_numpy(input_ids).to(device)).penultimate_hidden_state
        ones = torch.ones(input_ids.shape, dtype=torch.int32, device=device)
        n = len(_p)
        return TextEncodingOutput(hidden[:n], ones[:n], hidden[n:], ones[n:])
