"""PyTorch/CUDA port of ``gan_ffn_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports ``torch`` and
numpy and nothing of JAX.  Its module layout follows the JAX package's, and
every Pallas kernel on a ported path becomes a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).
Ported so far: the ``GAN_FFN`` serving path (``serving.py``,
``cli/serve.py``) and both IEMOCAP trainers, stage A and stage B
(``cli/train_iemocap.py`` for ``GAN_FFN``,
``cli/train_iemocap_dialoguernn.py`` for ``GAN_FFN_DialogueRNN``), which
run all four kernels, forward and backward; their stage A data-parallel
over ``torch.distributed`` (``--dp``, ``parallel/``); and the GAN-epoch and
multi-seed sweeps (``cli/sweep.py``, ``cli/seed_sweep.py``).
"""
