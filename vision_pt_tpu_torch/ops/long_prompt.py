"""CLIP 77-token-limit workaround: chunked long-prompt tokenization (the
port's own copy of ``vision_pt_tpu/ops/long_prompt.py``).

Works on token ids with NumPy; the tokenizer only needs an HF-like __call__
returning padded input_ids plus bos/eos/pad token ids.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol, Sequence

import numpy as np


class TokenizerLike(Protocol):
    bos_token_id: int
    eos_token_id: int
    pad_token_id: int

    def __call__(self, prompts, padding, truncation, max_length): ...


class TokenizedResult(NamedTuple):
    input_ids: np.ndarray  # (batch * num_chunks, chunk_length + 2)
    attention_mask: np.ndarray


def chunk_token_ids(
    input_ids: np.ndarray,  # (batch, max_length + 2) including bos/eos
    bos_token_id: int,
    eos_token_id: int,
    pad_token_id: int,
    max_length: int = 75 * 3,
    chunk_length: int = 75,
) -> TokenizedResult:
    """Strip outer bos/eos, split into chunks, re-wrap each chunk with
    bos/eos (reference ``long_prompt.py:16-71``)."""
    if max_length % chunk_length != 0:
        raise ValueError(
            f"max_length {max_length} must be divisible by chunk_length {chunk_length}"
        )
    inner = input_ids[:, 1:-1]  # remove outer bos/eos
    batch = inner.shape[0]
    num_chunks = max_length // chunk_length
    chunks = inner.reshape(batch, num_chunks, chunk_length)
    bos = np.full((batch, num_chunks, 1), bos_token_id, dtype=chunks.dtype)
    eos = np.full((batch, num_chunks, 1), eos_token_id, dtype=chunks.dtype)
    chunks = np.concatenate([bos, chunks, eos], axis=-1)
    chunks = chunks.reshape(batch * num_chunks, chunk_length + 2)
    attention_mask = np.where(chunks == pad_token_id, 0, 1).astype(np.int32)
    return TokenizedResult(input_ids=chunks, attention_mask=attention_mask)


def tokenize_long_prompt(
    tokenizer,
    prompts: Sequence[str],
    max_length: int = 75 * 3,
    chunk_length: int = 75,
) -> TokenizedResult:
    """Tokenize then chunk (reference ``long_prompt.py:16-71``)."""
    encoded = tokenizer(
        list(prompts),
        padding="max_length",
        truncation=True,
        max_length=max_length + 2,
    )
    input_ids = np.asarray(encoded["input_ids"] if isinstance(encoded, dict)
                           else encoded.input_ids)
    return chunk_token_ids(
        input_ids,
        bos_token_id=tokenizer.bos_token_id,
        eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id,
        max_length=max_length,
        chunk_length=chunk_length,
    )
