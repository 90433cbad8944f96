"""JiT training entry points."""
