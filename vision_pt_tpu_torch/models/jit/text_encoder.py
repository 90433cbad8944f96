"""Qwen3 text conditioning encoder of text-conditioned JiT (port of
``vision_pt_tpu/models/jit/text_encoder.py``).

The port's ``models/lm`` decoder with the Qwen3-VL-2B text tower's config;
the conditioning is its penultimate hidden state (the state entering the
last layer). For text-only inputs Qwen3-VL's multimodal rotary collapses to
rotate-half RoPE (its three position streams are equal), so the decoder is
exact. Positives and negatives go through one forward, and the attention
masks are all ones, pad tokens included, as in the JAX package.

Weights are local: :meth:`TextEncoder.from_local` reads an HF-style
directory (``config.json``, ``*.safetensors``, tokenizer files); nothing is
downloaded and :meth:`TextEncoder.from_remote` raises. The tokenizer is
pluggable: HF's ``AutoTokenizer`` from the directory, or
:class:`QwenWordHashTokenizer`, which needs no vocabulary file.
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ...utils import PromptType
from ..lm.model import DecoderLM, DecoderLMConfig

DEFAULT_REPO = "p1atdev/Qwen3-VL-2B-Instruct-Text-Only"
DEFAULT_MAX_TOKEN_LENGTH = 128
PAD_TOKEN_ID = 151643  # Qwen's <|endoftext|>

# the Qwen3-VL-2B text tower
QWEN3_VL_2B_TEXT_CONFIG = DecoderLMConfig(
    vocab_size=151936,
    hidden_size=2048,
    intermediate_size=6144,
    num_hidden_layers=28,
    num_attention_heads=16,
    num_key_value_heads=8,
    head_dim=128,
    rms_norm_eps=1e-6,
    rope_theta=5_000_000.0,
    attention_bias=False,
    arch="qwen3",
)


class QwenWordHashTokenizer:
    """HF-like tokenizer without a vocabulary file: each word maps to a
    stable hash in [0, 151643), below Qwen's special tokens; no token is
    prepended (Qwen adds none), and rows are padded on the right with
    151643, as Qwen's tokenizer pads."""

    pad_token_id = PAD_TOKEN_ID

    def __call__(self, texts, max_length=DEFAULT_MAX_TOKEN_LENGTH,
                 padding="longest", truncation=True, add_special_tokens=True):
        rows = [[zlib.crc32(w.encode()) % PAD_TOKEN_ID for w in text.split()]
                for text in texts]
        rows = [r[:max_length] if truncation else r for r in rows]
        width = max(map(len, rows)) if padding == "longest" else max_length
        ids = [r + [PAD_TOKEN_ID] * (width - len(r)) for r in rows]
        return {"input_ids": np.asarray(ids, dtype=np.int64).reshape(len(rows), width)}


class TextEncodingOutput(NamedTuple):
    positive_embeddings: torch.Tensor
    positive_attention_mask: torch.Tensor
    negative_embeddings: torch.Tensor | None
    negative_attention_mask: torch.Tensor | None


def _config_from_hf(hf: dict) -> DecoderLMConfig:
    base = QWEN3_VL_2B_TEXT_CONFIG
    fields = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "head_dim", "rms_norm_eps",
              "rope_theta", "attention_bias")
    return dataclasses.replace(base, **{f: hf.get(f, getattr(base, f)) for f in fields})


def _tower_key(key: str) -> str:
    """A key of a Qwen3-VL file as the port's ``DecoderLM`` names it: the HF
    prefixes stripped, and ``.weight`` after a bare norm scale."""
    key = (key.removeprefix("model.language_model.").removeprefix("language_model.")
           .removeprefix("model."))
    return key if key.endswith((".weight", ".bias")) else key + ".weight"


class TextEncoder:
    """The LM and its tokenizer: a plain object, not a module, as in the JAX
    package, so checkpoints of the JiT model leave the tower out."""

    def __init__(self, model: DecoderLM, tokenizer):
        self.model = model
        self.tokenizer = tokenizer

    @classmethod
    def from_default(cls, tokenizer=None, *,
                     config: DecoderLMConfig = QWEN3_VL_2B_TEXT_CONFIG,
                     dtype: torch.dtype | None = None,
                     param_dtype: torch.dtype = torch.float32,
                     generator: torch.Generator | None = None) -> "TextEncoder":
        """The Qwen3-VL-2B text tower with random weights from ``generator``,
        on the current default device (real use needs weights)."""
        model = DecoderLM(config, dtype=dtype, param_dtype=param_dtype,
                          generator=generator).eval()
        return cls(model, tokenizer)

    @classmethod
    def from_remote(cls, repo_id: str = DEFAULT_REPO) -> "TextEncoder":
        raise NotImplementedError(
            "Text-conditioned JiT needs the Qwen3 encoder weights available "
            f"locally (repo: {repo_id}); nothing is downloaded. Put config.json, "
            "the safetensors and the tokenizer files in a directory and use "
            "TextEncoder.from_local(path). Class-conditioned JiT "
            "(ClassContextConfig) needs no weights."
        )

    @classmethod
    def from_local(cls, path: str, *, dtype: torch.dtype | None = None,
                   device: str | torch.device = "cpu") -> "TextEncoder":
        """The tower from an HF-style directory on ``device``: Qwen3-VL's
        nested ``text_config`` (or a flat config), the safetensors' HF names
        with their ``model.`` / ``language_model.`` prefixes stripped and
        ``lm_head`` left out; fp32 parameters, computing in ``dtype``. A bare
        norm key (no ``.weight``, as the JAX package's own files have it)
        loads too. Weights the files lack keep their random init (seed 0),
        as in the JAX package. The tokenizer is ``AutoTokenizer`` from the
        directory's files, or None."""
        from safetensors.torch import load_file

        d = Path(path)
        hf = json.loads((d / "config.json").read_text())
        config = _config_from_hf(hf.get("text_config", hf))
        with torch.device(device):
            gen = torch.Generator(device=device).manual_seed(0)
            model = DecoderLM(config, dtype=dtype, generator=gen).eval()
        sd = {}
        for f in sorted(d.glob("*.safetensors")):
            sd |= {_tower_key(k): v for k, v in load_file(str(f)).items()
                   if not k.startswith("lm_head.")}
        model.load_state_dict(sd, strict=False)

        tokenizer = None
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(str(d), local_files_only=True)
        except Exception:  # no tokenizer files: set one before encoding
            pass
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

    @torch.inference_mode()
    def encode_prompts(
        self,
        prompts: PromptType,
        negative_prompts: PromptType | None = None,
        use_negative_prompts: bool = False,
        max_token_length: int = DEFAULT_MAX_TOKEN_LENGTH,
    ) -> TextEncodingOutput:
        """Positives and negatives in one forward; the penultimate hidden
        state and all-ones masks out."""
        if self.tokenizer is None:
            raise RuntimeError(
                "JiT text encoding needs a Qwen tokenizer with local files "
                f"(repo: {DEFAULT_REPO}); nothing is downloaded. Pass one (or "
                "QwenWordHashTokenizer()) as the encoder's tokenizer.")
        _p, _n = self.normalize_prompts(prompts, negative_prompts,
                                        use_negative_prompts)
        enc = self.tokenizer(_p + _n, max_length=max_token_length, padding="longest",
                             truncation=True, add_special_tokens=True)
        ids = np.asarray(enc["input_ids"] if isinstance(enc, dict) else enc.input_ids)
        device = self.model.embed_tokens.weight.device
        ids = torch.from_numpy(ids.astype(np.int64)).to(device)
        hidden = self.model(ids).penultimate_hidden_state
        ones = torch.ones(ids.shape, dtype=torch.int32, device=device)
        n = len(_p)
        return TextEncodingOutput(
            positive_embeddings=hidden[:n], positive_attention_mask=ones[:n],
            negative_embeddings=hidden[n:] if _n else None,
            negative_attention_mask=ones[n:] if _n else None,
        )
