"""PyTorch/CUDA port of ``gan_ffn_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports ``torch`` and
numpy and nothing of JAX.  Its module layout follows the JAX package's, and
every Pallas kernel on a ported path becomes a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).
Everything the JAX package does is ported, but its TPU-only tools (the
executable cache ``utils/aot.py`` and the kernel switches
``ops/config.py``, which have no counterpart here): the ``GAN_FFN`` serving path
and the other two serving families (``serving.py``, ``cli/serve.py``,
``cli/export.py``, ``cli/predict.py``); both IEMOCAP trainers, stage A and
stage B (``cli/train_iemocap.py`` for ``GAN_FFN``,
``cli/train_iemocap_dialoguernn.py`` for ``GAN_FFN_DialogueRNN``), which
run all four kernels, forward and backward, at f32 and bf16, per batch or
epoch-fused; the MELD trainer (``cli/train_meld.py``); data parallelism
over ``torch.distributed`` (``--dp``, ``parallel/``) and the GAN-epoch and
multi-seed sweeps (``cli/sweep.py``, ``cli/seed_sweep.py``); the JAX
package's msgpack checkpoints; the reference's ``.pth`` import
(``cli/import_reference.py``); the CUDA runtime settings
(``utils/runtime.py``); the forward check and the data-parallel dry run
(``graft_entry.py``); and the library-only models, losses and AVEC and
DailyDialog data that no entry point runs (``BiE2EModel``, the baselines,
``nn/losses.py``, ``data/``).
"""
