"""JiT: pixel-space rectified-flow Diffusion Transformer (port)."""

from .class_encoder import ClassEncoder, ClassTokenizer
from .config import (
    ClassContextConfig,
    DenoiserConfig,
    JiT_B_16_Config,
    JiTConfig,
    TextContextConfig,
)
from .denoiser import Denoiser, JiT
from .pipeline import JiTModel

__all__ = [
    "ClassContextConfig", "ClassEncoder", "ClassTokenizer", "Denoiser",
    "DenoiserConfig", "JiT", "JiTConfig", "JiTModel", "JiT_B_16_Config",
    "TextContextConfig",
]
