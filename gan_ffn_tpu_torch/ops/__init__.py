"""Kernel wrappers: hand-written CUDA on the card, plain PyTorch on the CPU."""
