"""Checkpoint tools of the port: import validation, dtype and format conversion."""
