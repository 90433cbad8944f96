"""Class-label conditioning encoder (port of
``vision_pt_tpu/models/jit/class_encoder.py``). Tokenization is host-side
NumPy; the lookup is an ``nn.Embedding`` whose zero padding row sits at index
``num_classes``."""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ...utils import PromptType


class ClassTokenizerOutput(NamedTuple):
    class_ids: np.ndarray  # (B, L) int32
    attention_mask: np.ndarray  # (B, L) int32; right-padded


class ClassTokenizer:
    """Tag string -> right-padded id sequence."""

    def __init__(self, label2id: dict[str, int], splitter: str = " ",
                 do_mask_padding: bool = True) -> None:
        if not all(i < len(label2id) for i in label2id.values()):
            raise ValueError("All label IDs must be less than the number of classes.")
        self.label2id = label2id
        self.id2label = {v: k for k, v in label2id.items()}
        self.splitter = splitter
        self.do_mask_padding = do_mask_padding
        self.pad_token_id = len(label2id)

    def normalize_prompts(self, class_names: PromptType) -> list[str]:
        return class_names if isinstance(class_names, list) else [class_names]

    def tokenize(self, prompts: PromptType, max_length: int = 32) -> ClassTokenizerOutput:
        ids_batch: list[list[int]] = []
        for text in self.normalize_prompts(prompts):
            ids = []
            for label in text.split(self.splitter):
                label = label.strip()
                if not label:
                    continue
                label_id = self.label2id.get(label)
                if label_id is not None:
                    ids.append(label_id)
                else:
                    warnings.warn(f"Label '{label}' not found in label2id mapping.")
            ids_batch.append(ids)

        padded_ids = np.full((len(ids_batch), max_length), self.pad_token_id,
                             dtype=np.int32)
        mask = np.zeros((len(ids_batch), max_length), dtype=np.int32)
        for i, ids in enumerate(ids_batch):
            n = min(len(ids), max_length)
            padded_ids[i, :n] = ids[:n]
            mask[i, :n] = 1
        if not self.do_mask_padding:
            mask = np.ones_like(padded_ids)
        return ClassTokenizerOutput(class_ids=padded_ids, attention_mask=mask)


class ClassEncoderOutput(NamedTuple):
    embeddings: torch.Tensor
    attention_mask: torch.Tensor


class ClassEncoder(nn.Module):
    def __init__(self, label2id: dict[str, int], embedding_dim: int,
                 splitter: str = " ", do_mask_padding: bool = True, *,
                 param_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = len(label2id)
        self.pad_token_id = self.num_classes
        # a plain table, as in the JAX package: the padding row starts at 0
        # but takes gradients (a dropped context attends its padding tokens)
        self.embedding = nn.Embedding(
            self.num_classes + 1, embedding_dim, dtype=param_dtype,
        )
        with torch.no_grad():  # normal(0.02), zero padding row
            self.embedding.weight.normal_(0.0, 0.02, generator=generator)
            self.embedding.weight[self.pad_token_id].zero_()
        self.tokenizer = ClassTokenizer(label2id, splitter, do_mask_padding)

    def forward(self, class_ids: torch.Tensor) -> torch.Tensor:
        return self.embedding(class_ids)

    def encode_prompts(self, prompts: PromptType,
                       max_token_length: int = 32) -> ClassEncoderOutput:
        class_ids, attention_mask = self.tokenizer.tokenize(
            prompts, max_length=max_token_length
        )
        device = self.embedding.weight.device
        return ClassEncoderOutput(
            embeddings=self(torch.from_numpy(class_ids).long().to(device)),
            attention_mask=torch.from_numpy(attention_mask).to(device),
        )
