"""SDXL dual CLIP text encoders (port of
``vision_pt_tpu/models/sdxl/text_encoder.py``).

A CLIP text model with the JAX package's module names (HF transformers'
``text_model.encoder.layers.N.self_attn.q_proj`` minus ``encoder``; the
converter adds it back). The dual encoder extracts as the reference does:
CLIP-L's penultimate hidden state, bigG's penultimate state and the
projected pooled output of the FIRST chunk, long prompts chunked to N x 75
with the inner bos/eos stripped on re-concatenation.

Tokenizers are pluggable: an HF ``CLIPTokenizer`` built from local files, or
:class:`WordHashTokenizer`, which needs no vocabulary file.
"""

from __future__ import annotations

import os
import re
import zlib
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import _exact_tf32
from ...ops.linear import Linear
from ...ops.long_prompt import tokenize_long_prompt
from ...ops.norm import LayerNorm
from ...utils import PromptType

CHUNK_LENGTH = 75


@dataclass
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768
    eos_token_id: int = 2


# openai/clip-vit-large-patch14
TEXT_ENCODER_1_CONFIG = CLIPTextConfig()
# laion/CLIP-ViT-bigG-14
TEXT_ENCODER_2_CONFIG = CLIPTextConfig(
    hidden_size=1280,
    intermediate_size=5120,
    num_hidden_layers=32,
    num_attention_heads=20,
    hidden_act="gelu",
    projection_dim=1280,
)


class WordHashTokenizer:
    """HF-like tokenizer without a vocabulary file: each word maps to a
    stable hash in [0, 49406), with CLIP's special ids (bos 49406, eos and
    pad 49407). eos is the largest id of the base vocabulary, so CLIP's
    legacy ``argmax(input_ids)`` pooling finds it. Added tokens take the ids
    from 49408 on and, as in HF, are split out of the text wherever they
    stand, spaces or not."""

    bos_token_id = 49406
    eos_token_id = 49407
    pad_token_id = 49407
    base_vocab_size = 49408

    def __init__(self):
        self.added_tokens: dict[str, int] = {}

    def __len__(self) -> int:
        return self.base_vocab_size + len(self.added_tokens)

    def add_tokens(self, tokens, special_tokens: bool = False) -> int:
        """Add tokens not yet known; returns how many were added."""
        added = 0
        for token in [tokens] if isinstance(tokens, str) else tokens:
            if token not in self.added_tokens:
                self.added_tokens[token] = len(self)
                added += 1
        return added

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.added_tokens[token]

    def _ids(self, text: str) -> list[int]:
        pieces = [text]
        if self.added_tokens:
            pattern = "(" + "|".join(map(re.escape, sorted(self.added_tokens, key=len,
                                                           reverse=True))) + ")"
            pieces = re.split(pattern, text)
        ids = []
        for piece in pieces:
            if piece in self.added_tokens:
                ids.append(self.added_tokens[piece])
            else:
                ids += [zlib.crc32(w.encode()) % self.bos_token_id for w in piece.split()]
        return ids

    def __call__(self, prompts, padding="max_length", truncation=True,
                 max_length=77, return_tensors=None):
        """Padded ids as a numpy array whatever ``return_tensors`` asks."""
        out = []
        for text in prompts:
            ids = [self.bos_token_id]
            ids += self._ids(text)
            ids = ids[: max_length - 1] + [self.eos_token_id]
            ids += [self.pad_token_id] * (max_length - len(ids))
            out.append(ids)
        return {"input_ids": np.asarray(out, dtype=np.int64)}


def load_tokenizers(spec: str):
    """(tokenizer_1, tokenizer_2) from a local directory holding the two CLIP
    tokenizers (``tokenizer/``, ``tokenizer_2/``, HF layout), or the
    word-hash stand-in for ``"word-hash"``. Nothing is downloaded."""
    if spec == "word-hash":
        return WordHashTokenizer(), WordHashTokenizer()
    from transformers import CLIPTokenizer

    return tuple(CLIPTokenizer.from_pretrained(os.path.join(spec, sub),
                                               local_files_only=True)
                 for sub in ("tokenizer", "tokenizer_2"))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _act(name: str):
    if name == "quick_gelu":
        return quick_gelu
    if name == "gelu":
        return F.gelu
    raise ValueError(name)


def _linear(din, dout, *, use_bias=True, dtype, param_dtype, generator):
    return Linear(din, dout, use_bias=use_bias, dtype=dtype,
                  param_dtype=param_dtype, generator=generator, std=None)


class Embed(nn.Module):
    """``nnx.Embed``: the table in ``param_dtype``, rows cast to ``dtype``."""

    def __init__(self, num: int, features: int, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, features, dtype=param_dtype))
        with torch.no_grad():
            self.weight.normal_(0.0, features**-0.5, generator=generator)

    def forward(self, ids):
        out = F.embedding(ids, self.weight)
        return out.to(self.dtype) if self.dtype is not None else out


class CLIPAttention(nn.Module):
    def __init__(self, config: CLIPTextConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        d = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = d // self.num_heads
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.q_proj = _linear(d, d, **kw)
        self.k_proj = _linear(d, d, **kw)
        self.v_proj = _linear(d, d, **kw)
        self.out_proj = _linear(d, d, **kw)

    def forward(self, x, causal_mask):
        b, s, d = x.shape
        shape = (b, s, self.num_heads, self.head_dim)
        q = self.q_proj(x).reshape(shape)
        k = self.k_proj(x).reshape(shape)
        v = self.v_proj(x).reshape(shape)
        with _exact_tf32(q.dtype, q.device):  # fp32 logits of q, k
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits * (self.head_dim**-0.5) + causal_mask
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, config: CLIPTextConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.fc1 = _linear(config.hidden_size, config.intermediate_size, **kw)
        self.fc2 = _linear(config.intermediate_size, config.hidden_size, **kw)
        self.act = _act(config.hidden_act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    fsdp_unit = True  # gathered alone under FSDP (parallel.mesh)

    def __init__(self, config: CLIPTextConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        norm = dict(eps=config.layer_norm_eps, dtype=dtype, param_dtype=param_dtype)
        self.self_attn = CLIPAttention(config, **kw)
        self.layer_norm1 = LayerNorm(config.hidden_size, **norm)
        self.mlp = CLIPMLP(config, **kw)
        self.layer_norm2 = LayerNorm(config.hidden_size, **norm)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, config: CLIPTextConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.token_embedding = Embed(config.vocab_size, config.hidden_size, **kw)
        self.position_embedding = Embed(config.max_position_embeddings,
                                        config.hidden_size, **kw)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        return self.token_embedding(input_ids) + self.position_embedding(pos)


class CLIPTextModelOutput(NamedTuple):
    last_hidden_state: torch.Tensor
    penultimate_hidden_state: torch.Tensor
    pooler_output: torch.Tensor  # eos-token hidden state (after the final LN)
    text_embeds: torch.Tensor | None  # projected pooled (with projection only)


class TextModel(nn.Module):
    """HF ``CLIPTextModel.text_model``: embeddings, layers, final norm."""

    def __init__(self, config: CLIPTextConfig, *, dtype=None,
                 param_dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.embeddings = CLIPTextEmbeddings(config, **kw)
        self.layers = nn.ModuleList(CLIPEncoderLayer(config, **kw)
                                    for _ in range(config.num_hidden_layers))
        self.final_layer_norm = LayerNorm(config.hidden_size,
                                          eps=config.layer_norm_eps, dtype=dtype,
                                          param_dtype=param_dtype)


class CLIPTextModel(nn.Module):
    """CLIP text encoder; optional projection head (bigG)."""

    def __init__(self, config: CLIPTextConfig, with_projection: bool = False,
                 *, dtype=None, param_dtype=torch.float32, generator=None):
        super().__init__()
        self.config = config
        self.text_model = TextModel(config, dtype=dtype, param_dtype=param_dtype,
                                    generator=generator)
        self.text_projection = (
            _linear(config.hidden_size, config.projection_dim, use_bias=False,
                    dtype=dtype, param_dtype=param_dtype, generator=generator)
            if with_projection else None
        )

    def resize_token_embeddings(self, new_num_tokens: int) -> None:
        """Grow the vocabulary (HF's method); each new row is the mean row."""
        emb = self.text_model.embeddings.token_embedding
        table = emb.weight
        old = table.shape[0]
        if new_num_tokens <= old:
            return
        with torch.no_grad():
            mean = table.mean(dim=0, keepdim=True)
            grown = torch.cat([table, mean.expand(new_num_tokens - old, -1)]).to(table.dtype)
        emb.weight = nn.Parameter(grown, requires_grad=table.requires_grad)
        # a copy: the default configs are shared by every model built
        self.config = replace(self.config, vocab_size=new_num_tokens)

    def _embed_with_style(self, input_ids, style_embeddings, style_token_id,
                          style_offset=0):
        """Token embeddings with every occurrence of ``style_token_id``, in
        flat scan order over the batch and its chunks, replaced by the next
        row of ``style_embeddings`` (the reference's masked_scatter; past the
        last row the last one repeats), then the positions added. The first
        occurrence takes row ``style_offset`` (the occurrences in the rows
        of the batch before ``input_ids``, when these are a block of it)."""
        emb = self.text_model.embeddings
        tok = emb.token_embedding(input_ids)
        hidden = tok.shape[-1]
        flat_mask = (input_ids == style_token_id).reshape(-1)
        flat_styles = style_embeddings.reshape(-1, hidden)
        occurrence = torch.cumsum(flat_mask.int(), dim=0) - 1 + style_offset
        gathered = flat_styles[occurrence.clamp(0, flat_styles.shape[0] - 1)].to(tok.dtype)
        tok = torch.where(flat_mask[:, None], gathered, tok.reshape(-1, hidden))
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        return tok.reshape(*input_ids.shape, hidden) + emb.position_embedding(pos)

    def forward(self, input_ids: torch.Tensor, style_embeddings: torch.Tensor | None = None,
                style_token_id: int | None = None,
                style_offset: torch.Tensor | int = 0) -> CLIPTextModelOutput:
        """``style_embeddings`` (with ``style_token_id``): the style
        tokenizer's rows in place of the placeholder's embeddings, from row
        ``style_offset`` on."""
        tm = self.text_model
        if style_embeddings is not None:
            assert style_token_id is not None
            x = self._embed_with_style(input_ids, style_embeddings, style_token_id,
                                       style_offset)
        else:
            x = tm.embeddings(input_ids)
        seq = input_ids.shape[1]
        causal = torch.triu(torch.full((seq, seq), torch.finfo(torch.float32).min,
                                       device=input_ids.device), diagonal=1)
        penultimate = x
        for i, layer in enumerate(tm.layers):
            if i == len(tm.layers) - 1:
                penultimate = x
            x = layer(x, causal)
        last = tm.final_layer_norm(x)
        # pooled position: HF CLIP keeps the legacy argmax(input_ids) lookup
        # when eos_token_id == 2 (eot is the largest id of the real vocab);
        # otherwise the first literal eos
        if self.config.eos_token_id == 2:
            eos_pos = torch.argmax(input_ids, dim=-1)
        else:
            eos_pos = torch.argmax((input_ids == self.config.eos_token_id).int(), dim=-1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos_pos]
        text_embeds = (self.text_projection(pooled)
                       if self.text_projection is not None else None)
        return CLIPTextModelOutput(last, penultimate, pooled, text_embeds)


# ------------------------------------------------------------- dual encoder


class TextEncodingOutput(NamedTuple):
    positive_embeddings: torch.Tensor
    positive_attention_mask: torch.Tensor
    negative_embeddings: torch.Tensor
    negative_attention_mask: torch.Tensor


class PooledTextEncodingOutput(NamedTuple):
    positive_embeddings: torch.Tensor
    pooled_positive_embeddings: torch.Tensor
    negative_embeddings: torch.Tensor
    pooled_negative_embeddings: torch.Tensor


class MultipleTextEncodingOutput(NamedTuple):
    text_encoder_1: TextEncodingOutput
    text_encoder_2: PooledTextEncodingOutput


def _merge_chunks(hidden: torch.Tensor, batch: int) -> torch.Tensor:
    """(batch * chunks, 77, d) -> (batch, 2 + 75 * chunks, d): inner bos/eos
    stripped, the first bos and the last eos kept."""
    _, seq, dim = hidden.shape
    chunks = hidden.reshape(batch, -1, seq, dim)
    inner = chunks[:, :, 1:-1, :].reshape(batch, -1, dim)
    return torch.cat([chunks[:, 0, :1], inner, chunks[:, -1, -1:]], dim=1)


def _merge_mask(mask: np.ndarray, batch: int) -> np.ndarray:
    _, seq = mask.shape
    chunks = mask.reshape(batch, -1, seq)
    inner = chunks[:, :, 1:-1].reshape(batch, -1)
    return np.concatenate([chunks[:, 0, :1], inner, chunks[:, -1, -1:]], axis=1)


class TextEncoder:
    """The dual CLIP encoder."""

    def __init__(self, text_encoder_1: CLIPTextModel, tokenizer_1,
                 text_encoder_2: CLIPTextModel, tokenizer_2):
        self.text_encoder_1 = text_encoder_1
        self.tokenizer_1 = tokenizer_1
        self.text_encoder_2 = text_encoder_2
        self.tokenizer_2 = tokenizer_2

    @classmethod
    def from_default(cls, tokenizer_1=None, tokenizer_2=None, *, dtype=None,
                     param_dtype=torch.float32, generator=None) -> "TextEncoder":
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        return cls(CLIPTextModel(TEXT_ENCODER_1_CONFIG, **kw), tokenizer_1,
                   CLIPTextModel(TEXT_ENCODER_2_CONFIG, with_projection=True, **kw),
                   tokenizer_2)

    @staticmethod
    def escape_exclamation(text: str) -> str:
        return text.replace("!", " !")

    def normalize_prompts(self, prompts: PromptType,
                          negative_prompts: PromptType | None = None,
                          use_negative_prompts: bool = True):
        _p = prompts if isinstance(prompts, list) else [prompts]
        if use_negative_prompts:
            if negative_prompts is not None:
                _n = (negative_prompts if isinstance(negative_prompts, list)
                      else [negative_prompts])
                if len(_n) == 1 and len(_p) > 1:
                    _n = _n * len(_p)
            else:
                _n = [""] * len(_p)
        else:
            _n = []
        return ([self.escape_exclamation(t) for t in _p],
                [self.escape_exclamation(t) for t in _n])

    def _encode(self, model, tokenizer, prompts, max_token_length, **model_kwargs):
        ids, mask = tokenize_long_prompt(tokenizer, prompts,
                                         max_length=max_token_length,
                                         chunk_length=CHUNK_LENGTH)
        device = model.text_model.final_layer_norm.weight.device
        return model(torch.as_tensor(ids).to(device), **model_kwargs), mask

    def encode_prompts_text_encoder_1(self, prompts, negative_prompts=None,
                                      use_negative_prompts=False,
                                      max_token_length: int = CHUNK_LENGTH):
        _p, _n = self.normalize_prompts(prompts, negative_prompts,
                                        use_negative_prompts)
        num_pos, all_prompts = len(_p), _p + _n
        out, mask = self._encode(self.text_encoder_1, self.tokenizer_1,
                                 all_prompts, max_token_length)
        merged = _merge_chunks(out.penultimate_hidden_state, len(all_prompts))
        merged_mask = torch.from_numpy(_merge_mask(mask, len(all_prompts)))
        return TextEncodingOutput(merged[:num_pos], merged_mask[:num_pos],
                                  merged[num_pos:], merged_mask[num_pos:])

    def encode_prompts_text_encoder_2(self, prompts, negative_prompts=None,
                                      use_negative_prompts=False,
                                      max_token_length: int = CHUNK_LENGTH):
        _p, _n = self.normalize_prompts(prompts, negative_prompts,
                                        use_negative_prompts)
        num_pos, all_prompts = len(_p), _p + _n
        out, _ = self._encode(self.text_encoder_2, self.tokenizer_2,
                              all_prompts, max_token_length)
        merged = _merge_chunks(out.penultimate_hidden_state, len(all_prompts))
        # pooled: the projected embeds of the FIRST chunk only
        pooled = out.text_embeds.reshape(len(all_prompts), -1,
                                         out.text_embeds.shape[-1])[:, 0]
        return PooledTextEncodingOutput(merged[:num_pos], pooled[:num_pos],
                                        merged[num_pos:], pooled[num_pos:])

    def encode_prompts(self, prompts, negative_prompts=None,
                       use_negative_prompts=False, max_token_length: int = 75
                       ) -> MultipleTextEncodingOutput:
        return MultipleTextEncodingOutput(
            self.encode_prompts_text_encoder_1(prompts, negative_prompts,
                                               use_negative_prompts,
                                               max_token_length),
            self.encode_prompts_text_encoder_2(prompts, negative_prompts,
                                               use_negative_prompts,
                                               max_token_length),
        )
