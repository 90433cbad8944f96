"""SDXL with the style tokenizer (port of
``vision_pt_tpu/models/sdxl/adapter/style_tokenizer.py``).

A ``<|style|>`` placeholder is added to both CLIP tokenizers, each text
encoder's vocabulary grows by the mean row, and a vision tower with one
projector per encoder turns a reference image into the rows that replace the
placeholder's token embeddings before the CLIP stack runs. As in the JAX
package, encoder 1 sees the placeholder expanded to ``num_style_tokens``
copies and encoder 2 sees it once, and the rows go in flat order over the
batch: encoder 2's placeholder of caption ``i`` takes row ``i`` of the
flattened (B x N) rows, not row 0 of sample ``i``.
"""

from __future__ import annotations

import torch

from ....adapters.style_tokenizer import StyleTokenizerConfig, StyleTokenizerManager
from ....utils import resolve_device
from ...auto import AutoImageEncoder
from ..config import SDXLConfig
from ..pipeline import SDXLModel
from ..text_encoder import (
    CHUNK_LENGTH,
    MultipleTextEncodingOutput,
    PooledTextEncodingOutput,
    TextEncoder,
    TextEncodingOutput,
    _merge_chunks,
    _merge_mask,
)
from .ip_adapter import ReferenceImages
from .prompt_free import SDXLModelWithPFG


class SDXLModelWithStyleTokenizerConfig(SDXLConfig):
    adapter: StyleTokenizerConfig = StyleTokenizerConfig()


class TextEncoderWithStyle(TextEncoder):
    style_token: str = "<|style|>"
    num_style_tokens: int = 4
    style_token_id_1: int | None = None
    style_token_id_2: int | None = None

    def append_style_token_id(self, style_token: str = "<|style|>",
                              num_style_tokens: int = 4):
        """The placeholder added to both tokenizers, both vocabularies grown."""
        self.style_token = style_token
        self.num_style_tokens = num_style_tokens
        self.tokenizer_1.add_tokens(style_token, special_tokens=True)
        self.tokenizer_2.add_tokens(style_token, special_tokens=True)
        self.style_token_id_1 = self.tokenizer_1.convert_tokens_to_ids(style_token)
        self.style_token_id_2 = self.tokenizer_2.convert_tokens_to_ids(style_token)
        self.text_encoder_1.resize_token_embeddings(len(self.tokenizer_1))
        self.text_encoder_2.resize_token_embeddings(len(self.tokenizer_2))

    def preprocess_style_token(self, prompts):
        """The placeholder expanded to N copies, no spaces between them."""
        expand = self.style_token * self.num_style_tokens
        if isinstance(prompts, str):
            return prompts.replace(self.style_token, expand)
        if isinstance(prompts, list):
            return [p.replace(self.style_token, expand) for p in prompts]
        return prompts

    @staticmethod
    def _batch_styles(style_embeddings, negative_style_embeddings, use_negative_prompts):
        if style_embeddings is None:
            return None
        if negative_style_embeddings is None:
            negative_style_embeddings = torch.zeros_like(style_embeddings)
        if use_negative_prompts:
            return torch.cat([style_embeddings, negative_style_embeddings])
        return style_embeddings

    def encode_prompts_text_encoder_1(self, prompts, negative_prompts=None,
                                      use_negative_prompts=False,
                                      max_token_length: int = CHUNK_LENGTH,
                                      style_embeddings=None,
                                      negative_style_embeddings=None) -> TextEncodingOutput:
        # the placeholder expands for encoder 1 only, as in the JAX package
        _p, _n = self.normalize_prompts(
            self.preprocess_style_token(prompts),
            self.preprocess_style_token(negative_prompts)
            if negative_prompts is not None else None, use_negative_prompts)
        num_pos, all_prompts = len(_p), _p + _n
        styles = self._batch_styles(style_embeddings, negative_style_embeddings,
                                    use_negative_prompts)
        out, mask = self._encode(self.text_encoder_1, self.tokenizer_1, all_prompts,
                                 max_token_length, style_embeddings=styles,
                                 style_token_id=self.style_token_id_1)
        merged = _merge_chunks(out.penultimate_hidden_state, len(all_prompts))
        merged_mask = torch.from_numpy(_merge_mask(mask, len(all_prompts)))
        return TextEncodingOutput(merged[:num_pos], merged_mask[:num_pos],
                                  merged[num_pos:], merged_mask[num_pos:])

    def encode_prompts_text_encoder_2(self, prompts, negative_prompts=None,
                                      use_negative_prompts=False,
                                      max_token_length: int = CHUNK_LENGTH,
                                      style_embeddings=None,
                                      negative_style_embeddings=None
                                      ) -> PooledTextEncodingOutput:
        _p, _n = self.normalize_prompts(prompts, negative_prompts, use_negative_prompts)
        num_pos, all_prompts = len(_p), _p + _n
        styles = self._batch_styles(style_embeddings, negative_style_embeddings,
                                    use_negative_prompts)
        out, _ = self._encode(self.text_encoder_2, self.tokenizer_2, all_prompts,
                              max_token_length, style_embeddings=styles,
                              style_token_id=self.style_token_id_2)
        merged = _merge_chunks(out.penultimate_hidden_state, len(all_prompts))
        pooled = out.text_embeds.reshape(len(all_prompts), -1,
                                         out.text_embeds.shape[-1])[:, 0]
        return PooledTextEncodingOutput(merged[:num_pos], pooled[:num_pos],
                                        merged[num_pos:], pooled[num_pos:])

    def encode_prompts(self, prompts, negative_prompts=None, use_negative_prompts=False,
                       max_token_length: int = 75, style_tokens_1=None, style_tokens_2=None,
                       negative_style_tokens_1=None, negative_style_tokens_2=None
                       ) -> MultipleTextEncodingOutput:
        return MultipleTextEncodingOutput(
            self.encode_prompts_text_encoder_1(prompts, negative_prompts,
                                               use_negative_prompts, max_token_length,
                                               style_tokens_1, negative_style_tokens_1),
            self.encode_prompts_text_encoder_2(prompts, negative_prompts,
                                               use_negative_prompts, max_token_length,
                                               style_tokens_2, negative_style_tokens_2))


class ReferenceEncodeOutput:
    def __init__(self, style_tokens_1, style_tokens_2):
        self.style_tokens_1 = style_tokens_1
        self.style_tokens_2 = style_tokens_2


class SDXLModelWithStyleTokenizer(SDXLModel):
    config: SDXLModelWithStyleTokenizerConfig
    text_encoder_class = TextEncoderWithStyle

    def __init__(self, config: SDXLModelWithStyleTokenizerConfig, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None, **kw):
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        super().__init__(config, generator=generator, device=device, **kw)
        adapter_cfg = config.adapter
        self.manager = StyleTokenizerManager(adapter_config=adapter_cfg)
        self.vision_encoder = AutoImageEncoder(adapter_cfg.image_encoder, device=self.device)
        with self.device:
            self.projector_1 = self.manager.get_projector(
                self.text_encoder.text_encoder_1.config.hidden_size, generator=generator)
            self.projector_2 = self.manager.get_projector(
                self.text_encoder.text_encoder_2.config.hidden_size, generator=generator)
        self._reference = ReferenceImages(adapter_cfg, self.device)

    def to(self, device: str | torch.device) -> "SDXLModelWithStyleTokenizer":
        super().to(device)
        for module in (self.projector_1, self.projector_2, self.vision_encoder):
            module.to(self.device)
        self._reference.device = self.device
        return self

    def setup_style_token(self):
        """The placeholder added to both tokenizers, the vocabularies grown."""
        self.text_encoder.append_style_token_id(
            style_token=self.config.adapter.style_token,
            num_style_tokens=self.config.adapter.num_style_tokens)

    def _load_checkpoint(self, checkpoint_path: str, strict: bool = True):
        super()._load_checkpoint(checkpoint_path, strict=strict)
        self.setup_style_token()
        if self.config.adapter.checkpoint_weight:
            from safetensors.numpy import load_file

            self.manager.load_adapter_state(load_file(self.config.adapter.checkpoint_weight))

    def adapter_state_dict(self) -> dict[str, torch.Tensor]:
        return self.manager.get_state_dict()

    # ---------------------------------------------------------- images

    # PIL images, or NHWC arrays in [0, 1] or [-1, 1] -> the tower's input
    preprocess_reference_image = SDXLModelWithPFG.preprocess_reference_image

    def encode_reference_image(self, pixel_values: torch.Tensor) -> ReferenceEncodeOutput:
        with torch.no_grad():
            features = self.vision_encoder(pixel_values)
        return ReferenceEncodeOutput(self.projector_1(features).style_tokens,
                                     self.projector_2(features).style_tokens)

    # ---------------------------------------------------------- generate

    def generate(self, prompt, *args, reference_image=None, **kwargs):
        """SDXL sampling with the reference image's style rows in the
        placeholders (CFG's negative rows zero)."""
        style_tokens_1 = style_tokens_2 = None
        if reference_image is not None:
            with torch.inference_mode():
                pixels = (reference_image if isinstance(reference_image, torch.Tensor)
                          else self.preprocess_reference_image(reference_image))
                ref_out = self.encode_reference_image(pixels)
            style_tokens_1, style_tokens_2 = ref_out.style_tokens_1, ref_out.style_tokens_2
        return super().generate(
            prompt, *args, _encode_prompts_kwargs={"style_tokens_1": style_tokens_1,
                                                   "style_tokens_2": style_tokens_2},
            **kwargs)
