"""Datasets of the port (NumPy on the host)."""

from .preview import T2IPreviewArgs, TextToImagePreviewConfig

PreviewDatasetAlias = TextToImagePreviewConfig

__all__ = ["T2IPreviewArgs", "TextToImagePreviewConfig", "PreviewDatasetAlias"]
