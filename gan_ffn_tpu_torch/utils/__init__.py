"""Utilities: the weight bridge between JAX params and the port's modules,
the checkpoints in the JAX package's msgpack format (and the reader and
writer of that format), stage A's loss-history artifacts, TensorBoard
logging and profiling, the CUDA runtime settings and the import of the
reference's ``.pth`` checkpoints.

The names below load their module at first use: ``checkpoint`` imports
``train``, whose steps import ``utils.profiling``."""

import importlib

_MODULE_OF = {
    "append_loss_row": "artifacts",
    "configure_cuda_runtime": "runtime",
    "draw_gan_loss": "artifacts",
    "import_gan_save": "torch_import",
    "load_gan_loss_csv": "artifacts",
    "load_gan_state": "checkpoint",
    "load_params": "checkpoint",
    "save_gan_loss_csv": "artifacts",
    "save_gan_state": "checkpoint",
    "save_params": "checkpoint",
    "wait_for_device": "runtime",
}

__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_MODULE_OF[name]}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_MODULE_OF))
