"""Data parallelism and the multi-seed sweep over ``torch.distributed``
(counterpart of ``gan_ffn_tpu/parallel``)."""

from .mesh import (
    DataParallel,
    all_reduce_grads,
    batch_sharding,
    init_data_parallel,
    replicate,
    shard_batch,
)
from .sweep import (
    SeedGrid,
    TorchRNG,
    gather_seed_results,
    init_seed_sweep,
    make_grid_mesh,
    make_seed_mesh,
    make_sweep_train_step,
)

__all__ = [
    "DataParallel",
    "SeedGrid",
    "TorchRNG",
    "all_reduce_grads",
    "batch_sharding",
    "gather_seed_results",
    "init_data_parallel",
    "init_seed_sweep",
    "make_grid_mesh",
    "make_seed_mesh",
    "make_sweep_train_step",
    "replicate",
    "shard_batch",
]
