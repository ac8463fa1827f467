"""Multi-seed sweep over ``torch.distributed`` ranks (counterpart of
``gan_ffn_tpu/parallel/sweep.py``; BASELINE.json config 5).

The JAX package stacks N seeds' states on a leading axis, shards it over a
mesh axis and ``vmap``s one train step over it.  The port keeps one state
per seed (its own module, Adam, kernel seed source and torch RNG state) and
splits the seeds over ranks:

- :func:`make_seed_mesh`: one row per rank, seeds ``seeds[r::world]`` on
  rank ``r``;
- :func:`make_grid_mesh` ``(n_seed, n_data)``: ``n_seed`` rows of
  ``n_data`` ranks (rank = row * n_data + column, as JAX reshapes its
  devices); the seeds split over the rows, and each row trains its seeds
  data-parallel over its ranks, through a ``torch.distributed.new_group``
  per row (``parallel/mesh.py``).

Every local seed's step runs on the same batch (:func:`make_sweep_train_step`),
one after the other: where JAX vmaps each ``pallas_call`` over the seed
axis, the port launches each seed's kernels in turn.  The results come
back to every rank with ``all_gather_object`` (:func:`gather_seed_results`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import DataParallel


@dataclasses.dataclass(frozen=True)
class SeedGrid:
    """This rank's place in an ``n_seed`` x ``n_data`` grid: its ``row``
    (which seeds it trains) and ``data``, its data-parallel group within the
    row (no group where ``n_data`` is 1)."""

    n_seed: int
    n_data: int
    row: int
    column: int
    data: DataParallel

    def local_seeds(self, seeds: Sequence[int]) -> List[int]:
        """The seeds this rank's row trains: ``seeds[row::n_seed]``."""
        return list(seeds)[self.row::self.n_seed]


def make_grid_mesh(n_seed: int, n_data: Optional[int] = None,
                   dp: Optional[DataParallel] = None) -> SeedGrid:
    """The (seed, data) grid over ``dp``'s ranks (one process: 1 x 1).
    ``n_data`` defaults to ``world // n_seed``; ``n_seed * n_data`` must be
    the world size.  Every rank builds every row's group, as
    ``torch.distributed.new_group`` requires."""
    dp = dp if dp is not None else DataParallel()
    if n_data is None:
        n_data = dp.world // n_seed
    if n_seed < 1 or n_data < 1 or n_seed * n_data != dp.world:
        raise ValueError(f"a {n_seed} x {n_data} grid does not cover {dp.world} ranks")
    row, column = divmod(dp.rank, n_data)
    data = DataParallel(device=dp.device, backend=dp.backend)
    if n_data > 1:
        for r in range(n_seed):
            group = dist.new_group(ranks=[r * n_data + c for c in range(n_data)])
            if r == row:
                data = DataParallel(column, n_data, group, dp.device, dp.backend)
    return SeedGrid(n_seed, n_data, row, column, data)


def make_seed_mesh(dp: Optional[DataParallel] = None) -> SeedGrid:
    """One seed row per rank: :func:`make_grid_mesh` ``(world, 1)``."""
    return make_grid_mesh(dp.world if dp is not None else 1, 1, dp)


class TorchRNG:
    """One seed's own state of torch's RNG (the CPU generator's and the
    device's), seeded with ``seed``: :meth:`active` swaps it in around a
    step and keeps what the step drew, so a seed's ``F.dropout`` draws never
    depend on which other seeds run."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=self.devices):
            torch.manual_seed(seed)
            self._save()

    def _save(self):
        self.cpu = torch.get_rng_state()
        self.cuda = torch.cuda.get_rng_state(self.device) if self.devices else None

    @contextlib.contextmanager
    def active(self):
        with torch.random.fork_rng(devices=self.devices):
            torch.set_rng_state(self.cpu)
            if self.devices:
                torch.cuda.set_rng_state(self.cuda, self.device)
            yield
            self._save()


def init_seed_sweep(init_fn: Callable[[torch.Generator], object], seeds: Sequence[int],
                    grid: Optional[SeedGrid] = None) -> list:
    """The per-seed states of this rank's seeds (``grid.local_seeds``, or
    all of ``seeds`` without a grid), in order: ``init_fn(generator)`` with
    ``generator = torch.Generator().manual_seed(s)`` for seed ``s``."""
    local = grid.local_seeds(seeds) if grid is not None else list(seeds)
    return [init_fn(torch.Generator().manual_seed(s)) for s in local]


def make_sweep_train_step(steps: Sequence[Callable],
                          rngs: Optional[Sequence[TorchRNG]] = None) -> Callable:
    """``step(batch, *args) -> [out of each seed's step]``: every local
    seed's train step on the same batch, in order, each inside its own
    :class:`TorchRNG` where ``rngs`` gives them.  A seed's step built with
    its row's ``grid.data`` runs data-parallel over the row."""
    steps = list(steps)
    rngs = list(rngs) if rngs is not None else [None] * len(steps)

    def step(batch, *args):
        outs = []
        for fn, rng in zip(steps, rngs):
            with rng.active() if rng is not None else contextlib.nullcontext():
                outs.append(fn(batch, *args))
        return outs

    step.steps = steps
    return step


def gather_seed_results(results: Dict[int, object], grid: Optional[SeedGrid]) -> Dict[int, object]:
    """Every row's ``{seed: result}`` on every rank (``all_gather_object``
    over the world; a row's column 0 speaks for it).  One process: ``results``."""
    if grid is None or not dist.is_initialized():
        return dict(results)
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, results if grid.column == 0 else {})
    merged: Dict[int, object] = {}
    for part in gathered:
        merged.update(part)
    return merged
