"""SDXL training entry points."""
