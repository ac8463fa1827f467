"""Utilities: the weight bridge between JAX params and the port's modules,
the checkpoints in the JAX package's msgpack format (and the reader and
writer of that format), stage A's loss-history artifacts, TensorBoard
logging and profiling, the CUDA runtime settings and the import of the
reference's ``.pth`` checkpoints."""

from .artifacts import append_loss_row, draw_gan_loss, load_gan_loss_csv, save_gan_loss_csv
from .checkpoint import load_gan_state, load_params, save_gan_state, save_params
from .runtime import configure_cuda_runtime, wait_for_device
from .torch_import import import_gan_save

__all__ = [
    "append_loss_row",
    "configure_cuda_runtime",
    "draw_gan_loss",
    "import_gan_save",
    "load_gan_loss_csv",
    "load_gan_state",
    "load_params",
    "save_gan_loss_csv",
    "save_gan_state",
    "save_params",
    "wait_for_device",
]
