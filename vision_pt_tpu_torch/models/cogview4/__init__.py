"""CogView4 text-to-image: DiT, GLM-4 text encoder, VAE, sampler (port)."""

from .config import CogView4Config, DenoiserConfig
from .denoiser import CogView4DiT, Denoiser
from .pipeline import CogView4Model
from .text_encoder import GLMWordHashTokenizer, TextEncoder

__all__ = [
    "CogView4Config",
    "DenoiserConfig",
    "CogView4DiT",
    "Denoiser",
    "CogView4Model",
    "GLMWordHashTokenizer",
    "TextEncoder",
]
