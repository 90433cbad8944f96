"""Visualization tools of the port."""
