"""PickScore reward (port of ``vision_pt_tpu/reward/pickscore.py``).

PickScore (yuvalkirstain/PickScore_v1) is a CLIP-H/14 scorer. Both towers
are the port's own CLIP implementations (``models/clip_vision.py`` for the
images, ``models/sdxl/text_encoder.py``'s ``CLIPTextModel`` for the
prompts), each with its projection, and a logit scale, loaded from a local
HF directory; nothing is downloaded. Scoring takes image tensors and is
differentiable end to end: the preprocessing (an antialiased bicubic resize
and CLIP's normalization) runs on the tensors, so DRaFT+ backpropagates the
reward to the pixels. The towers are frozen.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Literal

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import resolve_device
from .utils import RewardModelConfig, RewardModelMixin, freeze_reward_params

# CLIP image preprocessing constants (openai/CLIP's processor)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def convert_hf_clip_text(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """An HF CLIP text state dict -> the port's ``CLIPTextModel`` keys (the
    torch layout stays: only HF's ``encoder.layers`` and an outer ``clip.``
    change; the vision keys are left out)."""
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        k = k.removeprefix("clip.")
        if not (k.startswith("text_model.") or k.startswith("text_projection")):
            continue
        out[k.replace(".encoder.layers.", ".layers.")] = np.asarray(v)
    return out


def _resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) weights of the antialiased bicubic resize of one axis:
    ``F.interpolate`` of the fp32 identity along its rows (the fp32 weights
    it and the JAX package resize with), held in fp64."""
    eye = torch.eye(n_in, dtype=torch.float32, device=device)[None, None]
    return F.interpolate(eye, size=(n_out, n_in), mode="bicubic", align_corners=False,
                         antialias=True)[0, 0].double()


def clip_preprocess_images(images: torch.Tensor, image_size: int = 224,
                           input_range: tuple[float, float] = (-1.0, 1.0)) -> torch.Tensor:
    """Differentiable CLIP preprocessing of NHWC images: to [0, 1], an
    antialiased bicubic resize to ``image_size`` (the JAX package's
    ``jax.image.resize(..., "bicubic")``: Keys' cubic with a = -0.5, widened
    when shrinking), CLIP's mean / std. No centre crop: the inputs are
    square."""
    lo, hi = input_range
    x = torch.clamp((images.float() - lo) / (hi - lo), 0.0, 1.0)
    # the resize as its two (out, in) weight matrices, the products in fp64
    # (no TF32): its backward is then two products, which run in a fixed order
    # on the card (F.interpolate's antialiased backward adds atomically there)
    _, h, w, _ = x.shape
    rows, cols = (_resize_matrix(size, image_size, x.device) for size in (h, w))
    x = torch.matmul(torch.matmul(rows, x.double().permute(0, 3, 1, 2)), cols.T)
    x = x.float().permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x - mean) / std


def _normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class PickScoreModel(nn.Module):
    """The CLIP dual tower and its logit scale, frozen."""

    def __init__(self, text_encoder: nn.Module, vision_encoder: nn.Module,
                 logit_scale: float = 4.6052):
        super().__init__()
        self.text_encoder = text_encoder
        self.vision_encoder = vision_encoder
        device = next(vision_encoder.parameters()).device
        self.register_buffer("logit_scale",
                             torch.tensor(logit_scale, dtype=torch.float32, device=device))
        freeze_reward_params(self)

    def embed_images(self, images: torch.Tensor, input_range=(-1.0, 1.0)) -> torch.Tensor:
        pixels = clip_preprocess_images(images, self.vision_encoder.config.image_size,
                                        input_range)
        return _normalized(self.vision_encoder(pixels).image_embeds)

    def embed_texts(self, input_ids: torch.Tensor) -> torch.Tensor:
        return _normalized(self.text_encoder(input_ids).text_embeds)

    def score(self, images: torch.Tensor, input_ids: torch.Tensor,
              input_range=(-1.0, 1.0)) -> torch.Tensor:
        """Per pair: exp(logit_scale) * <text_i, image_i> (the diagonal of
        text @ image.T)."""
        image_embs = self.embed_images(images, input_range)
        text_embs = self.embed_texts(input_ids)
        return torch.exp(self.logit_scale) * torch.sum(text_embs * image_embs, dim=-1)

    def probs(self, images: torch.Tensor, input_ids: torch.Tensor,
              input_range=(-1.0, 1.0)) -> torch.Tensor:
        """Softmax over the images for the FIRST prompt."""
        image_embs = self.embed_images(images, input_range)
        text_embs = self.embed_texts(input_ids)
        scores = torch.exp(self.logit_scale) * (text_embs @ image_embs.T)[0]
        return torch.softmax(scores, dim=-1)

    @classmethod
    def from_local(cls, path: str, *, dtype=None,
                   device: str | torch.device = "cpu") -> "PickScoreModel":
        """Load from a local HF CLIP directory (config.json + safetensors),
        e.g. a snapshot of yuvalkirstain/PickScore_v1, onto ``device``. A
        size missing from config.json takes PickScore_v1's (CLIP-H/14)."""
        from safetensors.numpy import load_file

        from ..models.clip_vision import CLIPVisionConfig, CLIPVisionModel, convert_hf_clip_vision
        from ..models.sdxl.text_encoder import CLIPTextConfig, CLIPTextModel

        d = Path(path)
        hf = json.loads((d / "config.json").read_text())
        tc, vc = hf.get("text_config", {}), hf.get("vision_config", {})
        projection_dim = hf.get("projection_dim", 1024)
        text_config = CLIPTextConfig(
            vocab_size=tc.get("vocab_size", 49408),
            hidden_size=tc.get("hidden_size", 1024),
            intermediate_size=tc.get("intermediate_size", 4096),
            num_hidden_layers=tc.get("num_hidden_layers", 24),
            num_attention_heads=tc.get("num_attention_heads", 16),
            max_position_embeddings=tc.get("max_position_embeddings", 77),
            hidden_act=tc.get("hidden_act", "gelu"),
            layer_norm_eps=tc.get("layer_norm_eps", 1e-5),
            projection_dim=projection_dim,
            eos_token_id=tc.get("eos_token_id", 2),
        )
        vision_config = CLIPVisionConfig(
            hidden_size=vc.get("hidden_size", 1280),
            intermediate_size=vc.get("intermediate_size", 5120),
            num_hidden_layers=vc.get("num_hidden_layers", 32),
            num_attention_heads=vc.get("num_attention_heads", 16),
            image_size=vc.get("image_size", 224),
            patch_size=vc.get("patch_size", 14),
            layer_norm_eps=vc.get("layer_norm_eps", 1e-5),
            hidden_act=vc.get("hidden_act", "gelu"),
            projection_dim=projection_dim,
        )
        with torch.device(device):
            text = CLIPTextModel(text_config, with_projection=True, dtype=dtype)
            vision = CLIPVisionModel(vision_config, with_projection=True, dtype=dtype)
        sd: dict[str, np.ndarray] = {}
        for f in sorted(d.glob("*.safetensors")):
            sd |= load_file(str(f))
        if not sd:
            raise FileNotFoundError(f"no safetensors under {path}")
        for tower, converted in ((text, convert_hf_clip_text(sd)),
                                 (vision, convert_hf_clip_vision(sd))):
            tower.load_state_dict({k: torch.from_numpy(v) for k, v in converted.items()},
                                  strict=False)
        logit_scale = float(np.asarray(sd.get("logit_scale", 4.6052)))
        return cls(text.eval(), vision.eval(), logit_scale)


class PickScoreConfig(RewardModelConfig):
    type: Literal["pickscore"] = "pickscore"
    model_id: str = "yuvalkirstain/PickScore_v1"
    # a local HF snapshot directory (nothing is downloaded)
    weights_path: str | None = None
    max_token_length: int = 77
    # the port's own: a local tokenizer directory or "word-hash"; None takes
    # the weights directory, as the JAX package does
    tokenizer: str | None = None

    def load_model(self, device=None) -> "PickScoreRewardModel":
        return PickScoreRewardModel(model_id=self.model_id, weights_path=self.weights_path,
                                    max_token_length=self.max_token_length,
                                    tokenizer=self.tokenizer, device=device)


class PickScoreRewardModel(RewardModelMixin):
    """(images NHWC in [-1, 1], prompts) -> one differentiable score each.
    The host tokenises; the towers run on their device."""

    def __init__(self, model_id: str = "yuvalkirstain/PickScore_v1",
                 weights_path: str | None = None, score_fn: Callable | None = None,
                 max_token_length: int = 77, model: PickScoreModel | None = None,
                 tokenizer=None, device: str | torch.device | None = None):
        self.model_id = model_id
        self.weights_path = weights_path
        self.max_token_length = max_token_length
        self._score_fn = score_fn
        self._model = model
        self._tokenizer = tokenizer
        if self._model is None and weights_path is not None:
            self._model = PickScoreModel.from_local(weights_path, device=resolve_device(device))

    def set_score_fn(self, fn: Callable):
        self._score_fn = fn

    @property
    def model(self) -> PickScoreModel | None:
        return self._model

    @property
    def tokenizer(self):
        """A tokenizer object as given, else loaded from its spec: word-hash,
        or a local directory (the weights directory by default)."""
        if self._tokenizer is None or isinstance(self._tokenizer, str):
            spec = self._tokenizer or self.weights_path or self.model_id
            if spec == "word-hash":
                from ..models.sdxl.text_encoder import WordHashTokenizer

                self._tokenizer = WordHashTokenizer()
            else:
                from transformers import AutoTokenizer

                self._tokenizer = AutoTokenizer.from_pretrained(spec, local_files_only=True)
        return self._tokenizer

    def tokenize(self, prompts: list[str]) -> torch.Tensor:
        enc = self.tokenizer(prompts, padding="max_length", truncation=True,
                             max_length=self.max_token_length)
        ids = np.asarray(enc["input_ids"])
        return torch.as_tensor(ids, dtype=torch.long, device=self._model.logit_scale.device)

    def __call__(self, images: torch.Tensor, prompts: list[str]) -> torch.Tensor:
        if self._score_fn is not None:
            return self._score_fn(images, prompts)
        if self._model is None:
            raise RuntimeError(
                f"PickScore needs pretrained CLIP weights ({self.model_id}) and "
                "downloads nothing: give weights_path (a local HF snapshot) or "
                "inject score_fn.")
        return self._model.score(images, self.tokenize(list(prompts)))
