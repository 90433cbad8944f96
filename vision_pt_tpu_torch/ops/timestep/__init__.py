"""Timestep ops of the port."""

from .embedding import TextTimestepEmbedding, TimestepEmbedding, get_timestep_embedding
from .sampling import TimestepSamplingType, sample_timestep
from .schedule import get_flux_schedule, get_linear_schedule

__all__ = [
    "TimestepEmbedding",
    "TextTimestepEmbedding",
    "get_timestep_embedding",
    "TimestepSamplingType",
    "sample_timestep",
    "get_flux_schedule",
    "get_linear_schedule",
]
