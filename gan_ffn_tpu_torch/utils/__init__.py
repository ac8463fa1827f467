"""Utilities: the JAX-to-port weight bridge."""
