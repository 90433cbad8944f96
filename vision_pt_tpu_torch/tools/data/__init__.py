"""Data preparation tools of the port."""
