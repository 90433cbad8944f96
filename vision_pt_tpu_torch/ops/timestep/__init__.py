"""Timestep ops of the port."""
