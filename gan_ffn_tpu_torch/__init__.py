"""PyTorch/CUDA port of ``gan_ffn_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports ``torch`` and
numpy and nothing of JAX.  Its module layout follows the JAX package's, and
every Pallas kernel on a ported path becomes a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).
Ported so far: the ``GAN_FFN`` serving path (``serving.py``,
``cli/serve.py``) and its stage-B training (``cli/train_iemocap.py``), which
runs all four kernels, forward and backward.
"""
