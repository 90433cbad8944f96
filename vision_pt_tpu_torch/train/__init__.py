"""Training entry points of the port, run as ``python -m``."""
