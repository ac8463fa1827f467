"""Utilities: the JAX-to-port weight bridge, stage A's checkpoints and its
loss-history artifacts."""
