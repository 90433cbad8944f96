"""SDXL text-to-image: UNet, VAE, dual CLIP text encoders, sampler (port)."""

from .config import DenoiserConfig, SDXLConfig
from .denoiser import Denoiser, UNet
from .pipeline import SDXLModel
from .scheduler import Scheduler
from .text_encoder import CLIPTextModel, TextEncoder, WordHashTokenizer
from .vae import VAE

__all__ = [
    "CLIPTextModel", "Denoiser", "DenoiserConfig", "SDXLConfig", "SDXLModel",
    "Scheduler", "TextEncoder", "UNet", "VAE", "WordHashTokenizer",
]
