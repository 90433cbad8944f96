"""Decoder-only LM towers for text conditioning (port)."""

from .model import DecoderLM, DecoderLMConfig, from_jax_state

__all__ = ["DecoderLM", "DecoderLMConfig", "from_jax_state"]
